"""The data x pixel x model mesh (counterpart of ``reni_tpu/parallel/mesh.py``).

One rank is one device, so a mesh of ``n_data x n_pixel x n_model`` is that
many ranks (``WORLD_SIZE``). Rank ``r`` sits at ``(data, pixel, model)``
with ``r = (data * n_pixel + pixel) * n_model + model``, the row-major order
of JAX's ``make_mesh`` with the model axis minor. Its block of a batch is
its ``B / n_data`` rows (its data coordinate) and, where the pixel axis
divides, its ``P / n_pixel`` pixels; a pixel axis that does not divide is
replicated, and its partial sums then count on pixel coordinate 0 alone.
The model ranks of one (data, pixel) coordinate hold the same rows and
pixels.

The JAX package's GSPMD program inserts the psums; here the stage runners
hand each step its block (``ShardView``, entered with ``kernel_mesh``) and
the step sums over the mesh itself, DDP-style:

- after the backward, one flat bucket of every trainable leaf's gradient
  (a model-sharded leaf's slice included) and the step's loss partials is
  all-reduced over ``dp``, the data x pixel ranks of the rank's model
  coordinate (``ShardView.reduce``). That gives JAX's sums: weight
  gradients reduce over both axes, and the replicated latent table's rows
  get their per-image gradients, which only the ranks holding the image's
  pixels have;
- a per-image term that is not linear in its pixels (the cosine over the
  pixel axis of FIT_LATENT and FIT_INVERSE) all-reduces its pixel sums over
  ``pixel`` in the forward and their gradients in the backward
  (``ShardView.pixel_sum``); per-image terms (KLD, the prior, the cosine)
  count on pixel coordinate 0 only;
- with ``shard_latents`` the latent tables and their optimizer moments are
  padded to the data axis and row-sharded over it for the stage
  (``shard_latent_tables``); a batch's rows come from their owners through
  one all-reduce over ``data`` and their gradients go back through one over
  ``dp`` (``ShardView.latent_rows``);
- on a ``model`` axis (tensor parallelism, ``state_sharding(shard_model=)``)
  each decoder leaf and its optimizer moments hold the rank's slice for the
  stage (``shard_model_leaves``; Megatron's alternating column- and
  row-parallel layout of ``_tp_spec``) and the decoder runs as
  ``parallel/tp.py``'s sharded plain decoder, whose only collectives cross
  the model axis.

A step makes its all-reduces always in the same order, with no float
atomics, so two runs give the same bits and replicated parameters stay
bitwise equal on every rank. Device tensors cross ranks through
``all_reduce`` and ``broadcast`` only.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from reni_tpu_torch.params import tree_items
from reni_tpu_torch.utils.profiling import span

AXES = ("data", "pixel", "model")


@dataclasses.dataclass(eq=False)
class Mesh:
    """A ('data', 'pixel', 'model') mesh seen from one rank: the axis sizes,
    this rank's coordinates, its device and the process groups of its
    ``data`` axis (the ranks of its pixel and model coordinate), its
    ``pixel`` axis (of its data and model coordinate), its ``model`` axis
    (of its data and pixel coordinate), of ``dp`` (data x pixel at its
    model coordinate) and of ``all`` (every rank). Without groups
    (``Mesh(2, 2)``) it is a layout: it answers shape questions and takes
    part in no collective."""

    n_data: int = 1
    n_pixel: int = 1
    n_model: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    groups: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.data_index, rest = divmod(self.rank, self.n_pixel * self.n_model)
        self.pixel_index, self.model_index = divmod(rest, self.n_model)

    axis_names = AXES

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "pixel": self.n_pixel, "model": self.n_model}

    @property
    def size(self) -> int:
        return self.n_data * self.n_pixel * self.n_model

    def group(self, axis: str):
        """The process group of ``axis`` ('data', 'pixel', 'model', 'dp' or
        'all'), or None where no collective is needed (one rank on it, or a
        layout)."""
        n = {"data": self.n_data, "pixel": self.n_pixel, "model": self.n_model,
             "dp": self.n_data * self.n_pixel, "all": self.size}[axis]
        return self.groups.get(axis) if n > 1 else None

    def cols(self, n: int) -> slice:
        """This rank's slice of a feature axis of ``n`` sharded over 'model'
        (``n`` a multiple of the model axis)."""
        k = n // self.n_model
        return slice(self.model_index * k, (self.model_index + 1) * k)

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of ``n`` (a multiple of the data axis)."""
        if n % self.n_data:
            raise ValueError(f"batch of {n} rows does not divide the data axis ({self.n_data})")
        k = n // self.n_data
        return slice(self.data_index * k, (self.data_index + 1) * k)

    def pixels(self, npix: int) -> slice:
        """This rank's part of a pixel-sized axis: its ``npix / n_pixel``
        where that divides, else all of it (replicated)."""
        if pixel_axis_or_none(self, npix) is None:
            return slice(None)
        k = npix // self.n_pixel
        return slice(self.pixel_index * k, (self.pixel_index + 1) * k)


def make_mesh(n_data: int = -1, n_pixel: int = 1, n_model: int = 1, device=None) -> Mesh:
    """The mesh of this run's ranks: ``n_data x n_pixel x n_model`` must be
    the world size (``n_data=-1``: the world size over ``n_pixel x
    n_model``). Every rank calls it, in the same order as the other
    collectives: it makes the process groups. ``device`` is this rank's
    (``multihost.rank_device``)."""
    from reni_tpu_torch.parallel import multihost

    world = multihost.process_count()
    model = f" x model={n_model}" if n_model > 1 else ""
    if n_data == -1:
        if world % (n_pixel * n_model):
            raise ValueError(f"WORLD_SIZE {world} does not divide over pixel={n_pixel}{model}")
        n_data = world // (n_pixel * n_model)
    if n_data * n_pixel * n_model != world:
        raise ValueError(f"a mesh of data={n_data} x pixel={n_pixel}{model} = "
                         f"{n_data * n_pixel * n_model} ranks, but WORLD_SIZE is {world}: one "
                         "rank is one device")
    rank = multihost.process_index()
    groups = {}
    if dist.is_initialized():
        def at(d, p, m):
            return (d * n_pixel + p) * n_model + m

        # new_group is collective over the world: every rank makes every
        # group, in this order, and keeps its own
        for axis, members in (
                ("model", [[at(d, p, m) for m in range(n_model)]
                           for d in range(n_data) for p in range(n_pixel)]),
                ("data", [[at(d, p, m) for d in range(n_data)]
                          for p in range(n_pixel) for m in range(n_model)]),
                ("pixel", [[at(d, p, m) for p in range(n_pixel)]
                           for d in range(n_data) for m in range(n_model)])):
            for ranks in members:
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = g
        if n_model == 1:
            groups["dp"] = dist.group.WORLD
        else:
            for m in range(n_model):
                g = dist.new_group([at(d, p, m) for d in range(n_data) for p in range(n_pixel)])
                if m == rank % n_model:
                    groups["dp"] = g
        groups["all"] = dist.group.WORLD
    return Mesh(n_data, n_pixel, n_model, rank, multihost.rank_device(device), groups)


def model_axis_size(mesh: Mesh | None) -> int:
    return 1 if mesh is None else mesh.n_model


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def all_reduce_sum(tensors: list[torch.Tensor], group) -> None:
    """Sum each tensor over the ranks of ``group`` in place: one all_reduce
    a dtype over a flat bucket of them, in their order (no-op for None)."""
    if group is None or not tensors:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        off = 0
        for t in ts:
            t.copy_(flat[off : off + t.numel()].view_as(t))
            off += t.numel()


class _AllReduce(torch.autograd.Function):
    """Sum over ``fwd`` in the forward, the cotangent summed over ``bwd`` in
    the backward."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        y = x.clone()
        if fwd is not None:
            dist.all_reduce(y, group=fwd)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        if ctx.bwd is not None:
            dist.all_reduce(g, group=ctx.bwd)
        return g, None, None


# ---------------------------------------------------------------------------
# the step's view of its block
# ---------------------------------------------------------------------------


class ShardView:
    """What a step holds of a stage on ``mesh``: the images' axis 1 has
    ``extent`` entries (pixels, or render rows for FIT_INVERSE), of which
    the rank holds ``pix``; of a batch of ``n`` rows it holds ``rows(n)``.
    ``counts_pixels``: this rank's pixel partials count (False on a pixel
    replica); ``counts_images``: per-image terms count here (pixel
    coordinate 0). ``sharded`` are the latent-table tensors row-sharded for
    the stage (``shard_latent_tables``)."""

    def __init__(self, mesh: Mesh, extent: int, sharded: tuple = ()):
        self.mesh = mesh
        self.extent = extent
        self.pix = mesh.pixels(extent)
        self.split = self.pix != slice(None)
        self.counts_images = mesh.pixel_index == 0
        self.counts_pixels = self.split or self.counts_images
        self._sharded = {id(t) for t in sharded}

    def is_sharded(self, t: torch.Tensor) -> bool:
        return id(t) in self._sharded

    def rows(self, n: int) -> slice:
        return self.mesh.rows(n)

    def pixel_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the pixel axis where it is split, differentiably
        (the cotangent summed over it too); else ``x``."""
        if not self.split:
            return x
        g = self.mesh.group("pixel")
        return _AllReduce.apply(x, g, g)

    def latent_rows(self, tables: list[torch.Tensor], idx: torch.Tensor) -> list[torch.Tensor]:
        """This rank's rows ``idx[rows(B)]`` of each table. A row-sharded
        table holds rows ``[d * R, (d + 1) * R)`` on data coordinate ``d``:
        each owner writes its rows of the whole batch into a zero buffer,
        one all-reduce over ``data`` fills it, and its backward sums the
        rows' gradients over ``dp`` back to the owners."""
        rows = self.rows(idx.shape[0])
        if not any(self.is_sharded(t) for t in tables):
            return [t[idx[rows]] for t in tables]
        R = tables[0].shape[0]
        lo = self.mesh.data_index * R
        own = (idx >= lo) & (idx < lo + R)
        local = torch.clamp(idx - lo, 0, R - 1)
        buf = torch.cat([t[local] * own[:, None, None].to(t.dtype) for t in tables], dim=-1)
        full = _AllReduce.apply(buf, self.mesh.group("data"), self.mesh.group("dp"))[rows]
        k = tables[0].shape[-1]
        return [full[..., i * k : (i + 1) * k] for i in range(len(tables))]

    def reduce(self, params: list[torch.Tensor], metrics: dict) -> dict:
        """The step's one bucket: the gradients of ``params`` that are not
        row-sharded and the metric partials, summed over ``dp`` (a
        model-sharded leaf's slice sums with the same slice of the other
        data x pixel ranks; ``parallel/tp.py`` leaves every replicated leaf
        the same gradient on each model rank). Returns the summed metrics. A
        span ``mesh.reduce`` (``utils/profiling.py``)."""
        grads = [p.grad for p in params if p.grad is not None and not self.is_sharded(p)]
        names = list(metrics)
        vals = torch.stack([metrics[k].detach() for k in names])
        with span("mesh.reduce", vals):
            all_reduce_sum(grads + [vals], self.mesh.group("dp"))
        return {k: vals[i] for i, k in enumerate(names)}


_KERNEL_MESH: list[ShardView] = []


@contextlib.contextmanager
def kernel_mesh(mesh: Mesh | None, extent: int | None = None, sharded: tuple = ()):
    """Make ``mesh`` (and the stage's ``ShardView``) visible to the steps and
    the kernel dispatch for the block: the stage runners enter it around
    their steps. ``None`` shadows any outer mesh."""
    _KERNEL_MESH.append(None if mesh is None else ShardView(mesh, extent or 1, sharded))
    try:
        yield
    finally:
        _KERNEL_MESH.pop()


def active_view() -> ShardView | None:
    return _KERNEL_MESH[-1] if _KERNEL_MESH else None


def active_kernel_mesh() -> Mesh | None:
    view = active_view()
    return None if view is None else view.mesh


# ---------------------------------------------------------------------------
# placement: what a rank holds
# ---------------------------------------------------------------------------


def pixel_axis_or_none(mesh: Mesh, npix: int) -> str | None:
    """The one policy for a pixel-sized axis: 'pixel' where the extent
    divides the axis, else None (replicate). Shared by the resident and the
    streaming placement."""
    return "pixel" if npix % mesh.shape["pixel"] == 0 else None


def batch_sharding(mesh: Mesh, npix: int | None = None) -> tuple:
    """Specs of one batch: (imgs (B, P, 3), idx (B,), bmask (B,)): the rows
    over 'data', the pixels over 'pixel' where they divide. A spec names the
    axis of each dimension (None: whole); ``put_sharded`` reads it."""
    pix = "pixel" if npix is None else pixel_axis_or_none(mesh, npix)
    return ("data", pix, None), ("data",), ("data",)


def stream_chunk_shardings(mesh: Mesh, npix: int) -> tuple:
    """Specs of the chunked streaming path: the flat (K*B, P, 3) chunk
    shards its rows over 'data' (each rank holds its K local batches,
    ``stream_chunk_layout``) and its pixels by ``pixel_axis_or_none``; the
    (K, B) index and mask matrices shard their batch axis."""
    return ("data", pixel_axis_or_none(mesh, npix), None), (None, "data")


def _block(mesh: Mesh, shape: tuple, spec: tuple) -> tuple:
    out = []
    for n, axis in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axis == "data":
            out.append(mesh.rows(n))
        elif axis == "pixel":
            out.append(mesh.pixels(n))
        elif axis == "model":
            out.append(mesh.cols(n))
        else:
            out.append(slice(None))
    return tuple(out)


def put_sharded(x, mesh: Mesh, spec: tuple) -> torch.Tensor:
    """This rank's block of ``x`` (a tensor or an ndarray, the same whole
    value on every rank) under ``spec``, on the mesh's device."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t[_block(mesh, tuple(t.shape), spec)].to(mesh.device)


def stream_chunk_layout(mesh: Mesh, idx_chunk: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Row order and shard-local gather indices of one streaming chunk.

    ``idx_chunk`` is (K, B) dataset indices (B a multiple of the data
    axis). Returns ``(perm, rows)``: ``images[perm]`` lays the flat (K*B, P,
    3) chunk out data-shard-major, so that shard d's contiguous block is its
    own (K, B / n_data) rows, and ``rows`` is the (K, B) matrix of
    shard-local row indices ``chunk_gather`` takes (every shard's segment of
    row k holds ``k * Bd + arange(Bd)``)."""
    K, B = idx_chunk.shape
    nd = mesh.shape["data"]
    bd = B // nd
    perm = idx_chunk.reshape(K, nd, bd).transpose(1, 0, 2).reshape(-1)
    rows = np.tile(bd * np.arange(K)[:, None] + np.arange(bd), (1, nd))
    return perm, rows


def batch_local_positions(mesh: Mesh, n: int) -> np.ndarray | None:
    """Positions (in a batch or chunk of ``n`` rows, sharded over 'data') of
    this rank's rows, or None when that is all of them (one data rank)."""
    if mesh.n_data == 1:
        return None
    return np.arange(n)[mesh.rows(n)]


class PixelSlice:
    """ndarray-like view of a host source (an ndarray or a ``DiskRowSource``)
    that keeps ``pix`` of each row's pixels; ``prefetch`` passes through."""

    def __init__(self, source, pix: slice):
        self._src = source
        self._pix = pix
        n = len(range(*pix.indices(source.shape[1])))
        self.shape = (source.shape[0], n) + tuple(source.shape[2:])
        self.dtype = source.dtype
        pre = getattr(source, "prefetch", None)
        if pre is not None:
            self.prefetch = pre

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, rows):
        return self._src[rows][:, self._pix]


def put_rows(source, rows: np.ndarray, mesh: Mesh, spec: tuple) -> torch.Tensor:
    """``source[rows]`` (a batch or chunk) under ``spec``, gathering only
    this rank's rows: from a ``DiskRowSource`` the rank decodes just those."""
    pos = batch_local_positions(mesh, len(rows)) if spec and spec[0] == "data" else None
    local = rows if pos is None else np.asarray(rows)[pos]
    block = np.asarray(source[local])
    pix = mesh.pixels(block.shape[1]) if len(spec) > 1 and spec[1] == "pixel" else slice(None)
    return torch.from_numpy(np.ascontiguousarray(block[:, pix])).to(mesh.device)


def chunk_gather(block: torch.Tensor, rows) -> torch.Tensor:
    """One step's batch out of a rank's staged chunk block: the shard-local
    ``rows`` of ``stream_chunk_layout`` (no collective; the rank's block
    holds exactly its rows)."""
    return block[rows]


def shard_stage_data(mesh: Mesh, images, idx_b, bmask_b) -> tuple:
    """A stage's data on this rank: the image or render-target source (S, P,
    3) or (S, H, W, 3) keeps this rank's part of axis 1 where it divides the
    pixel axis, and all its rows (batches gather rows by index); the (nb, B)
    index and mask matrices stay whole (a step takes its rows)."""
    spec = (None, pixel_axis_or_none(mesh, images.shape[1]))
    return (put_sharded(images, mesh, spec),
            torch.as_tensor(np.asarray(idx_b), dtype=torch.long, device=mesh.device),
            torch.as_tensor(np.asarray(bmask_b), device=mesh.device))


# ---------------------------------------------------------------------------
# latent tables
# ---------------------------------------------------------------------------


def _is_latent_table(path: str, leaf) -> bool:
    return (isinstance(leaf, torch.Tensor) and leaf.ndim == 3 and leaf.shape[-1] == 3
            and "latents" in path.split("/"))


def _decoder_leaf_role(path: str):
    """A decoder leaf's role from its tree path: ('layers', i, 'w'|'b'),
    ('final', 'w'|'b'), ('mapping',) or None (not a decoder leaf)."""
    keys = path.split("/")
    if "decoder" not in keys:
        return None
    tail = keys[keys.index("decoder") + 1:]
    if len(tail) == 3 and tail[0] == "layers" and tail[1].isdigit():
        return ("layers", int(tail[1]), tail[2])
    if len(tail) == 2 and tail[0] == "final":
        return ("final", tail[1])
    if tail and tail[0] == "mapping":
        return ("mapping",)
    return None


def _n_trunk_layers(tree) -> int:
    """Entries of the decoder's ``layers`` list, from the leaf paths."""
    roles = [_decoder_leaf_role(path) for path, _ in tree_items(tree)]
    return max((r[1] + 1 for r in roles if r is not None and r[0] == "layers"), default=0)


def _tp_spec(path: str, leaf, n_model: int, n_trunk: int) -> tuple | None:
    """Megatron's alternating spec of one decoder leaf (JAX's ``_tp_spec``):
    even trunk layers column-parallel (``w`` as ``(None, "model")``, ``b``
    as ``("model",)``), odd ones row-parallel (``w`` as ``("model", None)``,
    ``b`` whole, added after the reduction); ``final.w`` row-parallel when
    the last trunk layer is even (its activations arrive sharded); the FiLM
    mapping network whole (its modulations are per image). None for a leaf
    that is not the decoder's. A feature width the model axis does not
    divide raises."""
    role = _decoder_leaf_role(path)
    if role is None:
        return None

    def check(dim: int) -> None:
        if dim % n_model:
            raise ValueError(
                f"decoder leaf {path} has feature dim {dim}, not divisible by the model axis "
                f"({n_model}); pick a model-axis size dividing HIDDEN_FEATURES")

    if role[0] == "layers":
        _, i, wb = role
        col = i % 2 == 0
        if wb == "w":
            check(leaf.shape[1] if col else leaf.shape[0])
            return (None, "model") if col else ("model", None)
        if col:
            check(leaf.shape[0])
            return ("model",)
        return ()
    if role[0] == "final" and role[1] == "w" and (n_trunk - 1) % 2 == 0:
        check(leaf.shape[0])
        return ("model", None)
    return ()


def state_sharding(mesh: Mesh, tree, shard_latents: bool = False,
                   shard_model: bool | None = None) -> dict:
    """{path: spec} of a parameter tree: every leaf replicated (``()``),
    except, with ``shard_latents``, the latent tables, row-sharded over
    'data' (``("data", None, None)``), and, with ``shard_model`` (default:
    on iff the mesh has a model axis > 1), the decoder's leaves in the
    tensor-parallel layout of ``_tp_spec``. A table whose rows do not divide
    the data axis raises: pad it first (``pad_latent_rows``; the runners
    do). Optimizer moments take their parameter's spec
    (``shard_model_leaves``)."""
    n_model = model_axis_size(mesh)
    if shard_model is None:
        shard_model = n_model > 1
    shard_model = shard_model and n_model > 1
    n_trunk = _n_trunk_layers(tree) if shard_model else 0
    out = {}
    for path, leaf in tree_items(tree):
        spec = _tp_spec(path, leaf, n_model, n_trunk) if shard_model else None
        if spec is None:
            spec = ()
            if shard_latents and _is_latent_table(path, leaf):
                if leaf.shape[0] % mesh.n_data:
                    raise ValueError(
                        f"latent table {path} has {leaf.shape[0]} rows, not divisible by the "
                        f"data axis ({mesh.n_data}); pad with pad_latent_rows() first")
                spec = ("data", None, None)
        out[path] = spec
    return out


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    if rows == t.shape[0]:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0],) + tuple(t.shape[1:]))])


def pad_latent_rows(tree, multiple: int) -> tuple[Any, dict]:
    """Every latent table of ``tree`` padded with zero rows to a multiple of
    ``multiple``. Batches index only real rows (``make_batches`` pads its
    index vectors with 0), so padded rows get no gradient and no update:
    slicing them off (``unpad_latent_rows``) gives the unpadded run bit for
    bit. Returns (padded tree, {path: original rows} of what was padded)."""
    sizes: dict = {}

    def pad(path, leaf):
        if isinstance(leaf, dict):
            return {k: pad(f"{path}{k}/", v) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return [pad(f"{path}{i}/", v) for i, v in enumerate(leaf)]
        if leaf is not None and _is_latent_table(path[:-1], leaf):
            target = -(-leaf.shape[0] // multiple) * multiple
            if target != leaf.shape[0]:
                sizes[path[:-1]] = leaf.shape[0]
                return _pad_rows(leaf, target)
        return leaf

    return pad("", tree), sizes


def unpad_latent_rows(tree, sizes: dict):
    """Inverse of ``pad_latent_rows``."""
    if not sizes:
        return tree

    def unpad(path, leaf):
        if isinstance(leaf, dict):
            return {k: unpad(f"{path}{k}/", v) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return [unpad(f"{path}{i}/", v) for i, v in enumerate(leaf)]
        s = sizes.get(path[:-1])
        return leaf if s is None else leaf[:s]

    return unpad("", tree)


def _latent_leaves(state) -> list[torch.Tensor]:
    """The latent tables of a TrainState, trainable and frozen, in order."""
    out = []
    for tree in (state.trainable, state.frozen):
        out += [t for path, t in tree_items(tree) if _is_latent_table(path, t)]
    return out


def _moments(state, t: torch.Tensor) -> dict:
    """The optimizer's per-element state tensors of parameter ``t``."""
    st = state.optimizer.optimizer.state.get(t, {})
    return {k: v for k, v in st.items()
            if isinstance(v, torch.Tensor) and v.shape == t.shape}


def _zero_filled(shard: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    R = shard.shape[0]
    full = shard.new_zeros((mesh.n_data * R,) + tuple(shard.shape[1:]))
    full[mesh.data_index * R : (mesh.data_index + 1) * R] = shard
    return full


def collect_rows(shard: torch.Tensor, rows: int, mesh: Mesh) -> torch.Tensor:
    """The whole ``rows``-row table of which ``shard`` is this rank's block
    (``shard_latent_tables``): an all-reduce over 'data' of zero buffers
    into which each rank writes its block. Collective."""
    full = _zero_filled(shard, mesh)
    all_reduce_sum([full], mesh.group("data"))
    return full[:rows]


def shard_latent_tables(state, mesh: Mesh) -> Callable[[], None]:
    """Row-shard the state's latent tables and their optimizer moments over
    the data axis, in place: each table is padded to a multiple of the axis
    and keeps rows ``[d * R, (d + 1) * R)`` on data coordinate ``d`` (the
    tensors stay the optimizer's, their ``.data`` swapped; ``row_shard``
    marks them for ``checkpoint.fetch_tree``). Returns the collective that
    undoes it: one all-reduce over 'data' of the shards in zero buffers,
    then the padding sliced off."""
    n, d = mesh.n_data, mesh.data_index
    undo = []
    for t in _latent_leaves(state):
        rows = t.shape[0]
        R = -(-rows // n)
        moments = _moments(state, t)
        t.data = _pad_rows(t.data, n * R)[d * R : (d + 1) * R].clone()
        t.row_shard = (rows, mesh)
        for k, v in moments.items():
            state.optimizer.optimizer.state[t][k] = _pad_rows(v, n * R)[d * R : (d + 1) * R].clone()
        undo.append((t, rows))

    def gather() -> None:
        # the moments as they are now: an optimizer makes its state at its
        # first step, inside the stage, in the shard's shape
        keys = [list(_moments(state, t)) for t, _ in undo]
        full = []
        for (t, _), ks in zip(undo, keys):
            st = state.optimizer.optimizer.state.get(t, {})
            full += [_zero_filled(x, mesh) for x in [t.data] + [st[k] for k in ks]]
        all_reduce_sum(full, mesh.group("data"))
        for (t, rows), ks in zip(undo, keys):
            t.data = full.pop(0)[:rows]
            for k in ks:
                state.optimizer.optimizer.state[t][k] = full.pop(0)[:rows]
            del t.row_shard

    gather.sharded = tuple(t for t, *_ in undo)
    return gather


def _narrow(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    return t.narrow(dim, mesh.cols(t.shape[dim]).start, t.shape[dim] // mesh.n_model)


def _zero_filled_cols(shard: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    shape = list(shard.shape)
    shape[dim] *= mesh.n_model
    full = shard.new_zeros(shape)
    _narrow(full, dim, mesh).copy_(shard)
    return full


def collect_cols(shard: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The whole tensor of which ``shard`` is this rank's slice along
    ``dim`` over 'model' (``shard_model_leaves``): an all-reduce over
    'model' of zero buffers into which each rank writes its slice.
    Collective."""
    full = _zero_filled_cols(shard, dim, mesh)
    all_reduce_sum([full], mesh.group("model"))
    return full


def shard_model_leaves(state, mesh: Mesh) -> Callable[[], None]:
    """Cut the state's decoder leaves, trainable or frozen, and their
    optimizer moments to this rank's slice of ``_tp_spec`` over the model
    axis, in place (the tensors stay the optimizer's, their ``.data``
    swapped, so moments made at the stage's first step are born in the
    slice's shape; ``model_shard`` marks them for
    ``checkpoint.fetch_tree``). Returns the collective that undoes it: one
    all-reduce over 'model' of the slices in zero buffers."""
    specs = state_sharding(mesh, state.params, shard_model=True)
    undo = []
    for path, t in tree_items(state.params):
        spec = specs[path]
        if "model" not in spec:
            continue
        dim = spec.index("model")
        moments = _moments(state, t)
        t.data = _narrow(t.data, dim, mesh).clone()
        t.model_shard = (dim, mesh)
        for k, v in moments.items():
            state.optimizer.optimizer.state[t][k] = _narrow(v, dim, mesh).clone()
        undo.append((t, dim))

    def gather() -> None:
        # the moments as they are now (born at the stage's first step), all
        # in one bucket
        keys = [list(_moments(state, t)) for t, _ in undo]
        full = []
        for (t, dim), ks in zip(undo, keys):
            st = state.optimizer.optimizer.state.get(t, {})
            full += [_zero_filled_cols(x, dim, mesh) for x in [t.data] + [st[k] for k in ks]]
        all_reduce_sum(full, mesh.group("model"))
        for (t, _), ks in zip(undo, keys):
            t.data = full.pop(0)
            for k in ks:
                state.optimizer.optimizer.state[t][k] = full.pop(0)
            del t.model_shard

    return gather


def shard_for_stage(state, mesh: Mesh, shard_latents: bool = False) -> Callable[[], None]:
    """What a rank holds of the state for a stage: the latent tables
    row-sharded with ``shard_latents``, the decoder model-sharded on a model
    axis. Returns the collective that makes it whole again; its ``sharded``
    are the row-sharded tables (``ShardView``)."""
    undo = []
    if shard_latents:
        undo.append(shard_latent_tables(state, mesh))
    if mesh.n_model > 1:
        undo.append(shard_model_leaves(state, mesh))

    def gather() -> None:
        for g in reversed(undo):
            g()

    gather.sharded = tuple(t for g in undo for t in getattr(g, "sharded", ()))
    return gather


# ---------------------------------------------------------------------------
# runners
# ---------------------------------------------------------------------------


def pad_batch_to(batch_size: int, multiple: int) -> int:
    """A batch must split evenly over the data axis; padded rows are
    zero-masked by the tasks layer, so rounding up is exact."""
    return -(-batch_size // multiple) * multiple


def sharded_stage_runner(mesh: Mesh, shard_latents: bool = False) -> Callable:
    """A drop-in for ``tasks.run_stage`` on ``mesh``: the batch padded to the
    data axis (its padded rows masked), each step given this rank's block of
    the images (``shard_stage_data``) and the whole batch's index and mask
    (``ShardView`` picks its rows), the latent tables row-sharded for the
    stage with ``shard_latents`` and the decoder model-sharded on a model
    axis (``shard_for_stage``); the returned state is whole."""
    from reni_tpu_torch.train import tasks as _tasks

    def run_stage(step_fn, state, images, n_epochs, batch_size):
        batch_size = pad_batch_to(batch_size, mesh.n_data)
        idx, bmask = _tasks.make_batches(images.shape[0], batch_size)
        imgs, idx_b, bmask_b = shard_stage_data(mesh, images, idx, bmask.astype(np.float32))
        bmask_b = bmask_b.to(imgs.dtype)
        rows = mesh.rows(batch_size)
        gather = shard_for_stage(state, mesh, shard_latents)
        epochs = []
        with kernel_mesh(mesh, images.shape[1], gather.sharded):
            for _ in range(n_epochs):
                ms = []
                for b in range(idx_b.shape[0]):
                    state, m = step_fn(state, (imgs[idx_b[b, rows]], idx_b[b], bmask_b[b]))
                    ms.append(m)
                epochs.append({k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]})
        gather()
        return state, {k: torch.stack([e[k] for e in epochs]).cpu().numpy() for k in epochs[0]}

    return run_stage


def decode_sharded(model, params, Z: torch.Tensor, directions: torch.Tensor,
                   mesh: Mesh | None = None) -> torch.Tensor:
    """A large decode with the direction axis split over every rank of the
    mesh (the batch whole on each): each rank decodes its slice of the P
    directions (1, P, 3) through the kernels, and one all-reduce of a zero
    buffer into which each rank writes its slice returns the whole (B, P,
    out) on every rank, as JAX's global array reads on every host."""
    if mesh is None:
        mesh = make_mesh()
    P, world, r = directions.shape[1], mesh.size, mesh.rank
    lo, hi = r * P // world, (r + 1) * P // world
    with torch.no_grad(), kernel_mesh(Mesh(1, world, rank=r, device=mesh.device), P):
        part = model.apply(params, Z, directions[:, lo:hi])
        out = part.new_zeros((part.shape[0], P) + tuple(part.shape[2:]))
        out[:, lo:hi] = part
        all_reduce_sum([out], mesh.group("all"))
    return out

