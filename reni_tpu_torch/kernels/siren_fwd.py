"""Fused decoder forward: the port of the forward half of
``reni_tpu/kernels/siren_pallas.py``.

``fused_apply`` (Cond-by-Concat) and ``fused_film_apply`` (FiLM) pack the
model parameters into the kernel layout (per-image first-layer weight A,
stacked hidden weights, channel-padded final layer), run the trunk, then
slice the real output channels and apply the output activation.

The trunk runs where its tensors are: on a CUDA tensor it is a
hand-written kernel of ``csrc/siren_fwd.cu`` (``siren_trunk_cuda``,
``film_trunk_cuda``); on a CPU tensor it is the plain PyTorch version
(``siren_trunk_reference``, ``film_trunk_reference``). A CUDA tensor never
takes the plain version: a build or launch failure raises.
``fused_apply_reference`` / ``fused_film_apply_reference`` always take the
plain version, on any device — the tests and ``chip_smoke.py`` hold the
kernels against them.

Two kernels serve a CUDA trunk, chosen by dtype and shape alone
(``fwd_route``): the fused kernel of ``csrc/fused_fwd.cuh`` (``"fused"``:
the bf16 trunk with H a multiple of 64 up to 256 and 1 to MAX_FUSED_MM H x H
products: every Zoo entry and serving shape) and the row-tile kernel of
``csrc/siren_fwd.cuh`` (``"tile"``: the float32 trunk, other widths, a FiLM
trunk of one layer), and past the widths whose row tile fits a CTA (float32
from H = 1,792, bf16 from 3,584) the layer-major passes in their output mode
(``"passes"``, ``siren_step.passes_output``, counted there). The fused kernel reads the hidden weights as swizzled
64-row slabs (``pack_slabs``), packed once per weight tensor and kept while
the tensor is unchanged (``weight_slabs``); a persistent grid of one CTA per
SM walks the (image, 128-row tile) items in order (``fused_schedule``).

Each wrapper counts its calls in ``.launches``; ``fused_fwd_launches`` and
``tile_fwd_launches`` count the launches of each route. The counters are
registered with ``utils/graphs.py::counter``, so that a CUDA graph's
replays count the launches they make.

The trunks are differentiable (``SirenTrunk``, ``FilmTrunk``: the
``custom_vjp`` of the JAX package). Their backward is the port of
``_bwd_kernel`` / ``_film_bwd_kernel`` in ``kernels/siren_bwd.py``: on the
card the kernel of ``csrc/siren_bwd.cu``, elsewhere its plain version.
Gradients reach the float32 parameters and the latents through the packing
below by ordinary autograd.

Operand layout (float32; K_PAD = C_PAD = 8):

    d_pad (B_d, P, 8) with B_d in (1, B), A (B, 8, H), b0 (B, 1, H),
    Ws (L, H, H), bs (L, H), Wf (H, 8), bf (1, 8)          -> (B, P, 8)
    FiLM: A0 (B, 8, H), Ws (T-1, H, H), bs (T, H),
          freqs / phases (B, 1, T*H), scaled freq*15+30     -> (B, P, 8)
"""

from __future__ import annotations

import ctypes
import sys
import threading

import torch

from reni_tpu_torch.core import encodings
from reni_tpu_torch.core.fastmath import sine_fns
from reni_tpu_torch.models import film as film_lib
from reni_tpu_torch.models import siren as siren_lib
from reni_tpu_torch.utils.graphs import counter, keep
from reni_tpu_torch.utils.profiling import span

C_PAD = 8  # output channels padded
K_PAD = 8  # direction-feature width padded (actual <= 4)
TRUNKS = ("bfloat16", "float32")
# launch geometry of csrc/siren_fwd.cu: row tiles, largest first
TILE_ROWS, ROW_PAD, WARPS = (64, 32, 16), 8, 8
SMEM_LIMIT = 227 * 1024  # H100 dynamic shared memory per block
# the fused kernel (csrc/fused_fwd.cuh): widths, depths, row tile, ring stages
FUSED_WIDTHS = (64, 128, 192, 256)
MAX_FUSED_MM = 16
FUSED_TILE = 128
FUSED_STAGES = (4, 3, 2)  # deepest first
SCHED_LOCKSTEP, SCHED_PINGPONG = 0, 1
fused_fwd_launches = 0  # launches of the fused kernel
tile_fwd_launches = 0  # launches of the row-tile kernel
counter(sys.modules[__name__], "fused_fwd_launches", "tile_fwd_launches")


def fwd_smem_bytes(tm: int, hidden: int, trunk: str) -> int:
    """Shared memory of a forward CTA with ``tm``-row tiles: two activation
    buffers and the per-warp staging tiles (``smem_bytes`` of
    ``csrc/siren_fwd.cuh``)."""
    act = 2 if trunk == "bfloat16" else 4
    return 2 * tm * (hidden + ROW_PAD) * act + WARPS * 256 * 4


def tile_rows(hidden: int, trunk: str) -> int | None:
    """The row tile the forward launch takes: the largest of TILE_ROWS whose
    CTA fits in shared memory (None: none fits)."""
    return next((tm for tm in TILE_ROWS if fwd_smem_bytes(tm, hidden, trunk) <= SMEM_LIMIT),
                None)


def model_axis_reason(mesh) -> str | None:
    """JAX's reason for declining the fused kernels on a mesh with a model
    (tensor-parallel) axis: they take whole weights on each rank (the port
    runs ``parallel/tp.py``'s plain decoder where JAX runs XLA)."""
    n = mesh.shape.get("model", 1) if mesh is not None else 1
    if n > 1:
        return (f"mesh has a model (tensor-parallel) axis of size {n}; the fused kernel needs "
                "chip-resident weights — the plain decoder with Megatron sharding instead")
    return None


def passes_width(hidden: int, trunk: str) -> bool:
    """Whether the layer-major passes take this width at any depth (bf16 a
    multiple of 64, float32 of 16): the forward's route where the row tile
    does not fit (``fwd_route`` "passes")."""
    return hidden > 0 and hidden % (64 if trunk == "bfloat16" else 16) == 0


def unsupported_reason(
    npix: int, hidden_features: int, batch: int | None = None,
    trunk: str = "bfloat16", mesh=None,
) -> str | None:
    """Why the CUDA kernels cannot take this shape (None = they can): the
    wmma tiles need a hidden width that is a multiple of 16, and a CTA's two
    activation buffers must fit in shared memory at one of the row tiles
    (64, 32 or 16 rows) unless the layer-major passes take the width
    (``passes_width``). Any batch and any pixel count work: the grids put
    images on x, and a ragged tail tile is masked.

    Mesh-aware: with a ``mesh`` (``parallel.mesh``) ``npix`` and ``batch``
    are the whole batch's, each rank launches the kernel on its block, so
    they must divide the pixel and data axes and the kernel's limits apply
    to the local extents; a model (tensor-parallel) axis declines the
    kernels outright, as in JAX (``model_axis_reason``)."""
    if mesh is not None:
        reason = model_axis_reason(mesh)
        if reason is not None:
            return reason
        n_px, n_dt = mesh.shape["pixel"], mesh.shape["data"]
        if npix % n_px:
            return f"npix={npix} not divisible by the pixel axis ({n_px})"
        if batch is not None and batch % n_dt:
            return f"batch={batch} not divisible by the data axis ({n_dt})"
        npix //= n_px
        batch = None if batch is None else batch // n_dt
    if npix < 1:
        return f"no pixels to decode (npix={npix})"
    if hidden_features < 16 or hidden_features % 16:
        return f"hidden_features={hidden_features} is not a multiple of 16"
    if tile_rows(hidden_features, trunk) is None and not passes_width(hidden_features, trunk):
        tm = TILE_ROWS[-1]
        smem = fwd_smem_bytes(tm, hidden_features, trunk)
        return (
            f"hidden_features={hidden_features} needs {smem} B of shared "
            f"memory per CTA with the {trunk} trunk at the smallest row tile "
            f"({tm} rows; limit {SMEM_LIMIT})"
        )
    return None


def fwd_route(trunk: str, hidden: int, n_mm: int) -> str:
    """The kernel a CUDA trunk of this dtype and shape takes: ``"fused"``
    (bf16, H in FUSED_WIDTHS, 1 <= n_mm <= MAX_FUSED_MM; ``n_mm`` counts
    the H x H products), ``"tile"`` where a row tile fits a CTA, else
    ``"passes"``: the layer-major passes' output mode
    (``siren_step.passes_output``; float32 from H = 1,792, bf16 from 3,584)."""
    fused = trunk == "bfloat16" and hidden in FUSED_WIDTHS and 1 <= n_mm <= MAX_FUSED_MM
    if fused:
        return "fused"
    return "tile" if tile_rows(hidden, trunk) is not None else "passes"


def _align128(n: int) -> int:
    return (n + 127) // 128 * 128


def fused_layout_bytes(hidden: int, n_mm: int, film: bool, stages: int) -> int:
    """Shared memory of a fused-kernel CTA with a ring of ``stages`` slabs
    (``fused_layout_at`` of ``csrc/fused_fwd.cuh``): the activation tile, the
    ring, the first-layer weight, the per-layer vectors, Wf, the barriers
    and the alignment slack."""
    vec = (3 if film else 1) * (n_mm + 1) * hidden * 4
    return (FUSED_TILE * hidden * 2 + stages * hidden * 64 * 2 + _align128(K_PAD * hidden * 4)
            + _align128(vec) + _align128(hidden * C_PAD * 2) + _align128(2 * stages * 8) + 1024)


def fused_layout(hidden: int, n_mm: int, film: bool) -> tuple[int, int] | None:
    """(stages, shared memory bytes) of the deepest ring that fits
    (``fused_layout``), or None."""
    for stages in FUSED_STAGES:
        total = fused_layout_bytes(hidden, n_mm, film, stages)
        if total <= SMEM_LIMIT:
            return stages, total
    return None


def fused_sched(hidden: int, stages: int) -> int:
    """The shipped schedule: the warpgroups take turns at the tensor cores
    (SCHED_PINGPONG) where the ring holds a whole layer, else lock step."""
    return SCHED_PINGPONG if stages >= hidden // 64 else SCHED_LOCKSTEP


def fused_grid(batch: int, npix: int, sms: int) -> int:
    """The persistent grid: one CTA per SM, at most one per item
    (``fused_grid`` of the header)."""
    return min(sms, batch * -(-npix // FUSED_TILE))


def fused_schedule(batch: int, npix: int, grid: int) -> list[list[tuple[int, int]]]:
    """The (image, tile) items each CTA of a launch on ``grid`` CTAs walks,
    in its order: CTA c takes items c * n // grid to (c + 1) * n // grid - 1
    of the image-major list (the kernel's loop)."""
    tiles = -(-npix // FUSED_TILE)
    items = batch * tiles
    return [[divmod(i, tiles) for i in range(c * items // grid, (c + 1) * items // grid)]
            for c in range(grid)]


def swz(row, col, rows: int):
    """Element offset of (row, col) in a swizzled K-major tile of ``rows``
    rows (``swz`` of ``csrc/wgmma.cuh``): [col / 64][row][64], the 16-byte
    chunk (col / 8) % 8 stored at chunk ^ (row % 8). Works on ints and
    integer tensors."""
    return (col >> 6) * rows * 64 + row * 64 + ((((col >> 3) & 7) ^ (row & 7)) << 3) + (col & 7)


def slab_offsets(hidden: int, device=None) -> torch.Tensor:
    """(H, H) int64: where W[k, n] of one layer lands in its packed slabs:
    element (n, k) of W^T in the swizzled (H / 64, H, 64) layout, slab kb
    (K rows 64 kb to 64 kb + 63) the contiguous kb-th H x 64 block."""
    k = torch.arange(hidden, device=device)[:, None]
    n = torch.arange(hidden, device=device)[None, :]
    return swz(n, k, hidden)


def pack_slabs(ws: torch.Tensor) -> torch.Tensor:
    """(L, H, H) hidden weights -> (L, H * H) bf16 in the fused kernel's
    slab order (``slab_offsets``)."""
    n_mm, hidden = ws.shape[0], ws.shape[-1]
    out = torch.empty((n_mm, hidden * hidden), dtype=torch.bfloat16, device=ws.device)
    out[:, slab_offsets(hidden, ws.device).flatten()] = ws.reshape(n_mm, -1).to(torch.bfloat16)
    return out


class _TensorCache:
    """Values derived from tensors, kept while those tensors are unchanged:
    keyed by their identities and version counters (an in-place update, as
    Adam's, bumps the counter). An entry holds its tensors, so no other
    tensor takes their identity while it lives; inference tensors, which
    have no version counter, are never cached. The oldest entries go first;
    a CUDA graph being captured holds what it is handed
    (``utils/graphs.py::keep``).
    The daemon decodes from several threads: a lock guards the entries."""

    def __init__(self, size: int):
        self.size, self.entries, self.lock = size, {}, threading.Lock()

    def get(self, tensors, make):
        if any(t.is_inference() for t in tensors):
            return make()
        key = tuple(id(t) for t in tensors)
        versions = tuple(t._version for t in tensors)
        with self.lock:
            hit = self.entries.get(key)
            if hit is not None and hit[1] == versions:
                return keep(hit[2])
            value = make()
            self.entries.pop(key, None)
            self.entries[key] = (tuple(tensors), versions, value)
            while len(self.entries) > self.size:
                self.entries.pop(next(iter(self.entries)))
            return keep(value)


_stacks = _TensorCache(8)
_slabs = _TensorCache(8)


def _stack(tensors: list) -> torch.Tensor:
    """torch.stack of per-layer weights; where autograd records nothing,
    the same tensor again while none of them has changed (so that its
    packed slabs are reused)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return torch.stack(tensors)

    def make():
        with torch.inference_mode(False), torch.no_grad():
            return torch.stack(tensors)

    return _stacks.get(tensors, make)


def weight_slabs(ws: torch.Tensor) -> torch.Tensor:
    """``pack_slabs(ws)``, packed once and kept while ``ws`` is unchanged."""
    return _slabs.get((ws,), lambda: pack_slabs(ws.detach()))


# ---------------------------------------------------------------------------
# packing: model parameters -> kernel operands
# ---------------------------------------------------------------------------


def _shared_grid(D: torch.Tensor) -> torch.Tensor:
    """A (B, P, 3) view whose batch stride is 0 is one shared grid."""
    if D.shape[0] > 1 and D.stride(0) == 0:
        return D[:1]
    return D


def _pad_last(x: torch.Tensor, width: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def _d_features(equivariance, Z, D, hidden_features, trunk, kind):
    D = _shared_grid(D)
    if D.shape[0] not in (1, Z.shape[0]):
        raise ValueError(
            f"direction grid batch {D.shape[0]} is neither 1 nor the latent "
            f"batch {Z.shape[0]}"
        )
    d_feats = encodings.d_features(equivariance, D)
    reason = unsupported_reason(
        d_feats.shape[1], hidden_features, batch=Z.shape[0], trunk=trunk
    )
    if reason:
        raise ValueError(f"unsupported shapes for the fused {kind} path: {reason}")
    return d_feats


def _final_operands(params):
    wf = _pad_last(params["final"]["w"], C_PAD)
    bf = _pad_last(params["final"]["b"], C_PAD)[None]
    return wf, bf


def pack_inputs(params, equivariance: str, ndims: int, Z, d_feats):
    """Cond-by-Concat operands: per-image A/bias0 from the first-layer
    weight split, stacked hidden layers, channel-padded final layer."""
    layer0 = params["layers"][0]
    w_ip, w_bias, w_direct = siren_lib.split_first_layer(
        layer0["w"], equivariance, ndims
    )
    parts = encodings.z_parts(equivariance, Z)
    a = torch.einsum("bcn,nh->bch", parts["proj"], w_ip)  # (B, c, H)
    if w_direct is not None:
        a = torch.cat((a, w_direct[None].expand(a.shape[0], *w_direct.shape)), 1)
    a_pad = torch.nn.functional.pad(a, (0, 0, 0, K_PAD - a.shape[1]))
    b0 = (parts["bias_feats"] @ w_bias + layer0["b"])[:, None, :]  # (B, 1, H)
    d_pad = _pad_last(d_feats, K_PAD)
    ws = _stack([l["w"] for l in params["layers"][1:]])  # (L, H, H)
    bs = torch.stack([l["b"] for l in params["layers"][1:]])  # (L, H)
    wf, bf = _final_operands(params)
    return d_pad, a_pad, b0, ws, bs, wf, bf


def pack_film_inputs(params, equivariance: str, Z, d_feats, hidden_features: int):
    """FiLM operands: the mapping network's scaled frequencies and phases,
    the per-image first-layer weight A0 with SO2 columns reordered to the
    ``d_features`` order, stacked trunk layers and padded final layer."""
    parts = encodings.z_parts(equivariance, Z)
    fr, ph = film_lib.apply_mapping_network(params["mapping"], parts["bias_feats"])
    fr = (fr * 15.0 + 30.0)[:, None, :]  # (B, 1, T*H)
    ph = ph[:, None, :]
    w0 = params["layers"][0]["w"]
    if equivariance == "SO2":
        # FiLM siren input is [|D_xz|, D_y, innerprod]; d_features is
        # [D_x, D_z, |D_xz|, D_y]
        a0 = torch.einsum("bcn,nh->bch", parts["proj"], w0[2:])
        a0 = torch.cat((a0, w0[:2][None].expand(a0.shape[0], 2, w0.shape[1])), 1)
    else:
        a0 = torch.einsum("bcn,nh->bch", parts["proj"], w0)
    a0_pad = torch.nn.functional.pad(a0, (0, 0, 0, K_PAD - a0.shape[1]))
    d_pad = _pad_last(d_feats, K_PAD)
    layers = params["layers"]
    ws = (
        _stack([l["w"] for l in layers[1:]])
        if len(layers) > 1
        else w0.new_zeros((0, hidden_features, hidden_features))
    )
    bs = torch.stack([l["b"] for l in layers])
    wf, bf = _final_operands(params)
    return d_pad, a0_pad, ws, bs, wf, bf, fr, ph


# ---------------------------------------------------------------------------
# plain PyTorch trunks
# ---------------------------------------------------------------------------


def _matmul(a: torch.Tensor, b: torch.Tensor, trunk: str) -> torch.Tensor:
    """Product with JAX's trunk semantics: for bf16, both operands rounded
    to bf16 and the product kept in float32 (a bf16 x bf16 product is exact
    in float32, so float32 matmul of the rounded values matches
    ``preferred_element_type=f32``; a bf16 torch.matmul would round the
    output instead)."""
    if trunk == "bfloat16":
        a = a.to(torch.bfloat16).float()
        b = b.to(torch.bfloat16).float()
    return torch.matmul(a, b)


def siren_trunk_reference(
    d_pad, a, b0, ws, bs, wf, bf, *, omega0, omega_h, trunk="bfloat16",
    fast_sine=False,
):
    """Plain version of the Cond-by-Concat trunk kernel -> (B, P, 8)."""
    sine, _ = sine_fns(fast_sine)
    h = sine(omega0 * (_matmul(d_pad, a, trunk) + b0))
    for i in range(ws.shape[0]):
        h = sine(omega_h * (_matmul(h, ws[i], trunk) + bs[i]))
    return _matmul(h, wf, trunk) + bf


def film_trunk_reference(
    d_pad, a0, ws, bs, wf, bf, fr, ph, *, trunk="bfloat16", fast_sine=False,
):
    """Plain version of the FiLM trunk kernel -> (B, P, 8)."""
    sine, _ = sine_fns(fast_sine)
    hidden = a0.shape[-1]
    h = None
    for i in range(bs.shape[0]):
        lo = i * hidden
        pre = (
            _matmul(d_pad, a0, trunk) if i == 0 else _matmul(h, ws[i - 1], trunk)
        ) + bs[i]
        h = sine(fr[..., lo : lo + hidden] * pre + ph[..., lo : lo + hidden])
    return _matmul(h, wf, trunk) + bf


# ---------------------------------------------------------------------------
# CUDA trunks
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I, _F, _L = ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    "reni_siren_fwd": [_P, _L, *[_P] * 7, _I, _I, _I, _I, _F, _F, _I, _I, _P],
    "reni_film_fwd": [_P, _L, *[_P] * 8, _I, _I, _I, _I, _I, _I, _P],
    "reni_siren_fwd_fused": [_P, _L, *[_P] * 7, _I, _I, _I, _I, _F, _F, _I, _I, _I, _I, _P],
    "reni_film_fwd_fused": [_P, _L, *[_P] * 8, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}


def _kernel(symbol: str):
    from reni_tpu_torch.kernels import _build

    lib = _build.load("siren_fwd")
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[symbol]
        fn.restype = ctypes.c_int
        lib.reni_error_string.argtypes = [ctypes.c_int]
        lib.reni_error_string.restype = ctypes.c_char_p
    return fn, lib


def _cuda_operands(kind, trunk, d_pad, batch, tensors):
    """Validate kernel operands; returns (float32 contiguous tensors,
    d batch stride). Weights in ``tensors`` keep their float32 type here;
    the caller casts the matmul weights for the trunk."""
    if trunk not in TRUNKS:
        raise ValueError(f"trunk must be one of {TRUNKS}, got {trunk!r}")
    for t in (d_pad, *tensors):
        if not t.is_cuda:
            raise ValueError(f"{kind} kernel operands must all be CUDA tensors")
    if d_pad.shape[0] not in (1, batch):
        raise ValueError(f"d batch {d_pad.shape[0]} is neither 1 nor {batch}")
    reason = unsupported_reason(d_pad.shape[1], tensors[0].shape[-1], batch, trunk)
    if reason:
        raise ValueError(f"the {kind} CUDA kernel cannot take these operands: {reason}")
    d = d_pad.float().contiguous()
    d_bstride = d.shape[1] * K_PAD if d.shape[0] > 1 else 0
    return d, d_bstride


def _weights(w: torch.Tensor, trunk: str) -> torch.Tensor:
    dtype = torch.bfloat16 if trunk == "bfloat16" else torch.float32
    return w.to(dtype).contiguous()


def _check(err: int, error_string, kind: str) -> None:
    """Raise on a nonzero cudaError_t ``err``; ``error_string`` is the
    library's bound ``*_error_string``."""
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"{kind} kernel launch failed: CUDA error {err} ({msg})")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous()


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _route(kind, route, trunk, hidden, n_mm) -> str:
    """The route of a call: ``fwd_route``'s unless the caller names one
    (the fused kernel only where ``fwd_route`` gives it)."""
    auto = fwd_route(trunk, hidden, n_mm)
    if route is None:
        return auto
    if route not in ("fused", "tile", "passes") or (route != "tile" and auto != route):
        raise ValueError(f"{kind}: no {route!r} route for the {trunk} trunk at H = {hidden}, "
                         f"{n_mm} products")
    return route


def _fused_args(ws, hidden, film, npix, batch, device, sched):
    """(slabs, stages, schedule, grid) of a fused launch."""
    n_mm = ws.shape[0]
    stages = fused_layout(hidden, n_mm, film)[0]
    sched = fused_sched(hidden, stages) if sched is None else sched
    if sched == SCHED_PINGPONG and stages < hidden // 64:
        raise ValueError(f"ping-pong needs a ring of a whole layer ({stages} stages at H = "
                         f"{hidden})")
    return weight_slabs(ws), stages, sched, fused_grid(batch, npix, _sm_count(device))


def _launched(route: str) -> None:
    global fused_fwd_launches, tile_fwd_launches
    if route == "fused":
        fused_fwd_launches += 1
    elif route == "tile":
        tile_fwd_launches += 1


def siren_trunk_cuda(
    d_pad, a, b0, ws, bs, wf, bf, *, omega0, omega_h, trunk="bfloat16",
    fast_sine=False, route=None, sched=None,
):
    """Cond-by-Concat trunk on the card (``csrc/siren_fwd.cu``) -> (B, P, 8):
    the kernel ``fwd_route`` picks, or ``route`` ("fused" / "tile" /
    "passes": ``siren_step.passes_output``);
    ``sched`` overrides the fused kernel's schedule (SCHED_*)."""
    batch, hidden = a.shape[0], a.shape[-1]
    d, d_bstride = _cuda_operands("siren_fwd", trunk, d_pad, batch, (a, b0, ws, bs, wf, bf))
    route = _route("siren_fwd", route, trunk, hidden, ws.shape[0])
    if route == "passes":
        from reni_tpu_torch.kernels.siren_step import passes_output

        out = passes_output(False, (d_pad, a, b0, ws, bs, wf, bf),
                            dict(omega0=omega0, omega_h=omega_h, trunk=trunk,
                                 fast_sine=fast_sine))
        fused_apply.launches += 1
        return out
    a, b0, bs, bf = _f32(a), _f32(b0), _f32(bs), _f32(bf)
    wf = _weights(wf, trunk)
    npix = d.shape[1]
    out = torch.empty((batch, npix, C_PAD), dtype=torch.float32, device=d.device)
    head = (d.data_ptr(), d_bstride, a.data_ptr(), b0.data_ptr())
    tail = (batch, npix, hidden, ws.shape[0], float(omega0), float(omega_h))
    if route == "fused":
        slabs, stages, sched, grid = _fused_args(ws, hidden, False, npix, batch, d.device, sched)
        fn, lib = _kernel("reni_siren_fwd_fused")
        args = (*head, slabs.data_ptr(), bs.data_ptr(), wf.data_ptr(), bf.data_ptr(),
                out.data_ptr(), *tail, int(bool(fast_sine)), stages, sched, grid)
    else:
        ws = _weights(ws, trunk)
        fn, lib = _kernel("reni_siren_fwd")
        args = (*head, ws.data_ptr(), bs.data_ptr(), wf.data_ptr(), bf.data_ptr(),
                out.data_ptr(), *tail, int(trunk == "bfloat16"), int(bool(fast_sine)))
    with torch.cuda.device(d.device):
        err = fn(*args, torch.cuda.current_stream(d.device).cuda_stream)
    _check(err, lib.reni_error_string, "siren_fwd")
    _launched(route)
    fused_apply.launches += 1
    return out


def film_trunk_cuda(
    d_pad, a0, ws, bs, wf, bf, fr, ph, *, trunk="bfloat16", fast_sine=False, route=None,
    sched=None,
):
    """FiLM trunk on the card (``csrc/siren_fwd.cu``) -> (B, P, 8); the
    route as for ``siren_trunk_cuda``."""
    batch, hidden = a0.shape[0], a0.shape[-1]
    d, d_bstride = _cuda_operands(
        "film_fwd", trunk, d_pad, batch, (a0, ws, bs, wf, bf, fr, ph)
    )
    route = _route("film_fwd", route, trunk, hidden, ws.shape[0])
    if route == "passes":
        from reni_tpu_torch.kernels.siren_step import passes_output

        out = passes_output(True, (d_pad, a0, ws, bs, wf, bf, fr, ph),
                            dict(trunk=trunk, fast_sine=fast_sine))
        fused_film_apply.launches += 1
        return out
    a0, bs, bf, fr, ph = _f32(a0), _f32(bs), _f32(bf), _f32(fr), _f32(ph)
    wf = _weights(wf, trunk)
    npix = d.shape[1]
    out = torch.empty((batch, npix, C_PAD), dtype=torch.float32, device=d.device)
    tail = (fr.data_ptr(), ph.data_ptr(), out.data_ptr(), batch, npix, hidden, bs.shape[0])
    if route == "fused":
        slabs, stages, sched, grid = _fused_args(ws, hidden, True, npix, batch, d.device, sched)
        fn, lib = _kernel("reni_film_fwd_fused")
        args = (d.data_ptr(), d_bstride, a0.data_ptr(), slabs.data_ptr(), bs.data_ptr(),
                wf.data_ptr(), bf.data_ptr(), *tail, int(bool(fast_sine)), stages, sched, grid)
    else:
        ws = _weights(ws, trunk)
        fn, lib = _kernel("reni_film_fwd")
        args = (d.data_ptr(), d_bstride, a0.data_ptr(), ws.data_ptr(), bs.data_ptr(),
                wf.data_ptr(), bf.data_ptr(), *tail, int(trunk == "bfloat16"),
                int(bool(fast_sine)))
    with torch.cuda.device(d.device):
        err = fn(*args, torch.cuda.current_stream(d.device).cuda_stream)
    _check(err, lib.reni_error_string, "film_fwd")
    _launched(route)
    fused_film_apply.launches += 1
    return out


# ---------------------------------------------------------------------------
# differentiable trunks
# ---------------------------------------------------------------------------


def _handoff_forward(film, ops, kw, weight_grads):
    """A differentiable forward on the card through the layer-major passes
    (``siren_step.passes_forward``: the wgmma or the tiled passes, by
    ``siren_step.pass_design``) where the backward takes them
    (``siren_step.pass_route``) and their scratch fits the device-memory
    budget: (output, handoff), or None. Counted in
    ``siren_step.passes_forward.launches``, not in the forward kernel's
    count."""
    from reni_tpu_torch.kernels import siren_step

    a, ws = ops[1], ops[2 if film else 3]
    if not siren_step.pass_route(kw["trunk"], a.shape[-1], ws.shape[0]):
        return None
    return siren_step.passes_forward(film, ops, kw, weight_grads)


class SirenTrunk(torch.autograd.Function):
    """The Cond-by-Concat trunk with its backward (the ``custom_vjp`` of
    ``make_fused_siren``). ``kernel=False`` runs the plain versions: the
    forward saves its inputs, not activations, and the backward recomputes
    them. ``kernel=True`` runs the CUDA kernels: on the passes' route
    (``siren_step.pass_route``) the forward runs as the passes and hands
    their scratch (h and the kept values of every row) to the backward,
    which does not compute the forward again; elsewhere, or when that
    scratch does not fit the card's memory budget, the forward kernel of
    ``csrc/siren_fwd.cu`` and a backward that recomputes
    (``siren_bwd.siren_trunk_bwd_cuda``). The weight gradients are computed
    only when a weight needs one; ``d_pad`` gets none."""

    @staticmethod
    def forward(ctx, d_pad, a, b0, ws, bs, wf, bf, kernel, kw):
        ctx.save_for_backward(d_pad, a, b0, ws, bs, wf, bf)
        ctx.kernel, ctx.kw, ctx.handoff = kernel, kw, None
        ops = (d_pad, a, b0, ws, bs, wf, bf)
        handed = kernel and _handoff_forward(False, ops, kw, any(ctx.needs_input_grad[3:7]))
        if handed:
            out, ctx.handoff = handed
            return out
        return SirenTrunk.trunks[kernel](*ops, **kw)

    @staticmethod
    def backward(ctx, g):
        from reni_tpu_torch.kernels import siren_bwd

        with span("kernels.trunk_bwd", g):
            if ctx.handoff is not None:
                grads = siren_bwd.bwd_from_handoff(ctx.handoff, g)
                ctx.handoff = None
            else:
                bwd = (siren_bwd.siren_trunk_bwd_cuda if ctx.kernel
                       else siren_bwd.siren_trunk_bwd_reference)
                grads = bwd(
                    *ctx.saved_tensors, g, weight_grads=any(ctx.needs_input_grad[3:7]), **ctx.kw
                )
        return (None, *grads, None, None)


class FilmTrunk(torch.autograd.Function):
    """The FiLM trunk with its backward (the ``custom_vjp`` of
    ``make_fused_film``); see ``SirenTrunk``."""

    @staticmethod
    def forward(ctx, d_pad, a0, ws, bs, wf, bf, fr, ph, kernel, kw):
        ctx.save_for_backward(d_pad, a0, ws, bs, wf, bf, fr, ph)
        ctx.kernel, ctx.kw, ctx.handoff = kernel, kw, None
        ops = (d_pad, a0, ws, bs, wf, bf, fr, ph)
        handed = kernel and _handoff_forward(True, ops, kw, any(ctx.needs_input_grad[2:6]))
        if handed:
            out, ctx.handoff = handed
            return out
        return FilmTrunk.trunks[kernel](*ops, **kw)

    @staticmethod
    def backward(ctx, g):
        from reni_tpu_torch.kernels import siren_bwd

        with span("kernels.trunk_bwd", g):
            if ctx.handoff is not None:
                grads = siren_bwd.bwd_from_handoff(ctx.handoff, g)
                ctx.handoff = None
            else:
                bwd = (siren_bwd.film_trunk_bwd_cuda if ctx.kernel
                       else siren_bwd.film_trunk_bwd_reference)
                grads = bwd(
                    *ctx.saved_tensors, g, weight_grads=any(ctx.needs_input_grad[2:6]), **ctx.kw
                )
        da0, dws, dbs, dwf, dbf, dfr, dph = grads
        return None, da0, dws, dbs, dwf, dbf, dfr, dph, None, None


SirenTrunk.trunks = (siren_trunk_reference, siren_trunk_cuda)
FilmTrunk.trunks = (film_trunk_reference, film_trunk_cuda)


def _trunk(fn, ops, kernel: bool, kw: dict):
    """Run a trunk: through its autograd Function when a gradient is needed,
    else directly (serving under inference_mode records nothing). A span
    ``kernels.trunk_fwd`` (``utils/profiling.py``); the Functions' backward
    is ``kernels.trunk_bwd``."""
    with span("kernels.trunk_fwd", ops[0]):
        if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
            return fn.apply(*ops, kernel, kw)
        return fn.trunks[kernel](*ops, **kw)


# ---------------------------------------------------------------------------
# model-facing entries
# ---------------------------------------------------------------------------


def _siren(params, equivariance, ndims, Z, D, *, hidden_layers, hidden_features,
           out_features, first_omega_0, hidden_omega_0, output_activation,
           trunk, fast_sine, kernel):
    d_feats = _d_features(equivariance, Z, D, hidden_features, trunk, "siren")
    ops = pack_inputs(params, equivariance, ndims, Z, d_feats)
    if ops[3].shape[0] != hidden_layers:
        raise ValueError(
            f"params have {ops[3].shape[0]} hidden layers, config says {hidden_layers}"
        )
    kw = dict(omega0=first_omega_0, omega_h=hidden_omega_0, trunk=trunk, fast_sine=fast_sine)
    out = _trunk(SirenTrunk, ops, kernel, kw)
    return siren_lib._output_activation(out[..., :out_features], output_activation)


def fused_apply(
    params, equivariance: str, ndims: int, Z, D, *, hidden_layers: int,
    hidden_features: int, out_features: int, first_omega_0: float,
    hidden_omega_0: float, output_activation: str | None,
    trunk: str = "bfloat16", fast_sine: bool = False,
):
    """Drop-in for ``siren.apply_siren_decomposed`` through the fused trunk.

    D: (1, P, 3) shared grid, (B, P, 3) per-image grids, or a (B, P, 3)
    view with batch stride 0 (read as one shared grid). CUDA tensors launch
    the kernel; CPU tensors take ``siren_trunk_reference``."""
    return _siren(
        params, equivariance, ndims, Z, D, hidden_layers=hidden_layers,
        hidden_features=hidden_features, out_features=out_features,
        first_omega_0=first_omega_0, hidden_omega_0=hidden_omega_0,
        output_activation=output_activation, trunk=trunk, fast_sine=fast_sine,
        kernel=Z.is_cuda,
    )


fused_apply.launches = 0
counter(fused_apply, "launches")


def fused_apply_reference(
    params, equivariance: str, ndims: int, Z, D, *, hidden_layers: int,
    hidden_features: int, out_features: int, first_omega_0: float,
    hidden_omega_0: float, output_activation: str | None,
    trunk: str = "bfloat16", fast_sine: bool = False,
):
    """``fused_apply`` through the plain PyTorch trunk (forward and
    backward), on any device."""
    return _siren(
        params, equivariance, ndims, Z, D, hidden_layers=hidden_layers,
        hidden_features=hidden_features, out_features=out_features,
        first_omega_0=first_omega_0, hidden_omega_0=hidden_omega_0,
        output_activation=output_activation, trunk=trunk, fast_sine=fast_sine,
        kernel=False,
    )


def _film(params, equivariance, Z, D, *, hidden_layers, hidden_features,
          out_features, output_activation, trunk, fast_sine, kernel):
    d_feats = _d_features(equivariance, Z, D, hidden_features, trunk, "film")
    ops = pack_film_inputs(params, equivariance, Z, d_feats, hidden_features)
    if ops[3].shape[0] != hidden_layers:
        raise ValueError(
            f"params have {ops[3].shape[0]} trunk layers, config says {hidden_layers}"
        )
    out = _trunk(FilmTrunk, ops, kernel, dict(trunk=trunk, fast_sine=fast_sine))
    return siren_lib._output_activation(out[..., :out_features], output_activation)


def fused_film_apply(
    params, equivariance: str, Z, D, *, hidden_layers: int, hidden_features: int,
    out_features: int, output_activation: str | None, trunk: str = "bfloat16",
    fast_sine: bool = False,
):
    """Drop-in for ``film.apply_film_decomposed`` through the fused trunk.
    The mapping network (per image) runs in PyTorch; the kernel fuses the
    per-pixel FiLM trunk. CUDA tensors launch the kernel; CPU tensors take
    ``film_trunk_reference``."""
    return _film(
        params, equivariance, Z, D, hidden_layers=hidden_layers,
        hidden_features=hidden_features, out_features=out_features,
        output_activation=output_activation, trunk=trunk, fast_sine=fast_sine,
        kernel=Z.is_cuda,
    )


fused_film_apply.launches = 0
counter(fused_film_apply, "launches")


def fused_film_apply_reference(
    params, equivariance: str, Z, D, *, hidden_layers: int, hidden_features: int,
    out_features: int, output_activation: str | None, trunk: str = "bfloat16",
    fast_sine: bool = False,
):
    """``fused_film_apply`` through the plain PyTorch trunk (forward and
    backward), on any device."""
    return _film(
        params, equivariance, Z, D, hidden_layers=hidden_layers,
        hidden_features=hidden_features, out_features=out_features,
        output_activation=output_activation, trunk=trunk, fast_sine=fast_sine,
        kernel=False,
    )
