"""The fused forward's CPU-side parts (reni_tpu_torch.kernels.siren_fwd): its
route, shared-memory layout, persistent schedule and weight-slab packing,
mirrors of csrc/fused_fwd.cuh that the card's tests hold against the
library, and the plain forward at the route's shapes against the JAX
package's Pallas kernels in interpret mode. The kernel itself runs only on
the card (tests/test_torch_cuda.py, chip_smoke.py).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_fwd_fused.py -q
"""

import os
import sys
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from reni_tpu.kernels import siren_pallas as jk
from reni_tpu.models.reni import RENIConfig as JConfig
from reni_tpu.models.reni import RENIModel as JModel
from reni_tpu_torch import params as tparams
from reni_tpu_torch.kernels import siren_fwd as tk

WIDTHS = (16, 32, 48, 64, 96, 128, 160, 192, 256, 320, 512, 1024)


@pytest.mark.parametrize("trunk", tk.TRUNKS)
def test_route_by_dtype_and_shape(trunk):
    """bf16 with H a multiple of 64 up to 256 and at least one product takes
    the fused kernel; everything else the row-tile kernel."""
    for hidden in WIDTHS:
        for n_mm in range(7):
            fused = trunk == "bfloat16" and hidden % 64 == 0 and hidden <= 256 and n_mm >= 1
            assert tk.fwd_route(trunk, hidden, n_mm) == ("fused" if fused else "tile"), (
                hidden, n_mm)
    assert tk.fwd_route("bfloat16", 256, tk.MAX_FUSED_MM) == "fused"
    assert tk.fwd_route("bfloat16", 256, tk.MAX_FUSED_MM + 1) == "tile"


# (npix, hidden, batch, trunk) -> declined? The shapes the forward took
# before the fused kernel; the route adds no limit.
REASONS = (
    ((1, 16, 1, "bfloat16"), False), ((8450, 256, 21, "bfloat16"), False),
    ((32768, 256, 21, "bfloat16"), False), ((32768, 256, 21, "float32"), False),
    ((129, 64, 2, "bfloat16"), False), ((127, 192, 1000, "bfloat16"), False),
    ((1000, 512, 3, "float32"), False), ((1000, 1024, 3, "bfloat16"), False),
    ((8192, 48, 21, "bfloat16"), False), ((1000, 1744, 3, "float32"), False),
    ((0, 256, 1, "bfloat16"), True), ((64, 24, 1, "bfloat16"), True),
    ((64, 8, 1, "float32"), True), ((64, 256, 65536, "bfloat16"), True),
    ((64, 1760, 1, "float32"), True), ((64, 3504, 1, "bfloat16"), True),
)


@pytest.mark.parametrize("shape,declined", REASONS)
def test_unsupported_reason_keeps_every_shape(shape, declined):
    assert (tk.unsupported_reason(*shape) is not None) == declined


def test_fused_layout_fits_every_routed_shape():
    """Every width and depth the route takes has a ring of at least two
    slabs; the Zoo's shapes a ring of a whole layer (ping-pong); the bytes
    add up as the header lays them out."""
    for film in (False, True):
        for hidden in tk.FUSED_WIDTHS:
            for n_mm in range(1, tk.MAX_FUSED_MM + 1):
                stages, total = tk.fused_layout(hidden, n_mm, film)
                assert stages in tk.FUSED_STAGES and total <= tk.SMEM_LIMIT
                if stages < tk.FUSED_STAGES[0]:
                    assert tk.fused_layout_bytes(hidden, n_mm, film, stages + 1) > tk.SMEM_LIMIT
    assert tk.fused_layout(256, 5, False) == (4, 216192)
    assert tk.fused_layout(256, 4, True) == (4, 225408)
    assert tk.fused_sched(256, 4) == tk.SCHED_PINGPONG
    assert tk.fused_sched(256, 3) == tk.SCHED_LOCKSTEP
    assert tk.fused_sched(64, 2) == tk.SCHED_PINGPONG


@pytest.mark.parametrize("hidden", tk.FUSED_WIDTHS)
def test_slab_packing_round_trips_at_the_swizzled_offsets(hidden):
    """pack_slabs puts W[k, n] at the header's swz(n, k, H) of its layer,
    each 64-row K slab is one contiguous H x 64 block, and gathering at
    the same offsets gives W back (rounded to bf16)."""
    gen = torch.Generator().manual_seed(hidden)
    ws = torch.randn((2, hidden, hidden), generator=gen)
    packed = tk.pack_slabs(ws)
    assert packed.dtype == torch.bfloat16 and packed.shape == (2, hidden * hidden)
    off = tk.slab_offsets(hidden)
    assert torch.equal(packed[:, off.flatten()].view(2, hidden, hidden), ws.to(torch.bfloat16))
    assert torch.equal(off.flatten().sort().values, torch.arange(hidden * hidden))
    k = torch.arange(hidden)[:, None].expand(hidden, hidden)
    assert torch.equal(off // (hidden * 64), k // 64)  # K rows 64 kb.. in slab kb
    rng = np.random.default_rng(hidden)
    for k_, n_ in rng.integers(0, hidden, size=(50, 2)):
        k_, n_ = int(k_), int(n_)
        chunk = ((k_ >> 3) & 7) ^ (n_ & 7)
        want = (k_ // 64) * hidden * 64 + n_ * 64 + chunk * 8 + k_ % 8
        assert tk.swz(n_, k_, hidden) == want
        assert packed[1, want] == ws[1, k_, n_].to(torch.bfloat16)


@pytest.mark.parametrize("npix", [1, 127, 128, 129, 8450, 32768])
def test_schedule_covers_every_tile_once_in_order(npix):
    """Every (image, tile) item once, image-major, each CTA a run of
    consecutive items, run lengths within one of each other, on the card's
    grid and on grids of 1, 3 and 132 CTAs."""
    for batch in (1, 2, 21, 100, 1000):
        tiles = -(-npix // tk.FUSED_TILE)
        every = [(b, t) for b in range(batch) for t in range(tiles)]
        for sms in (1, 3, 132):
            grid = tk.fused_grid(batch, npix, sms)
            assert grid == min(sms, len(every))
            runs = tk.fused_schedule(batch, npix, grid)
            assert [item for run in runs for item in run] == every
            sizes = [len(run) for run in runs]
            assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


def test_packed_slabs_follow_in_place_updates():
    """weight_slabs packs once per tensor and packs again after an in-place
    update; the stacked layer weights are the same tensor while no layer
    changes (no gradient recorded), fresh ones when autograd records, and
    inference tensors are never cached."""
    ws = torch.randn(3, 64, 64)
    first = tk.weight_slabs(ws)
    assert tk.weight_slabs(ws) is first
    ws.mul_(2.0)
    again = tk.weight_slabs(ws)
    assert again is not first and torch.equal(again, tk.pack_slabs(ws))
    layers = [torch.randn(64, 64) for _ in range(3)]
    stacked = tk._stack(layers)
    assert tk._stack(layers) is stacked
    layers[1].add_(1.0)
    restacked = tk._stack(layers)
    assert restacked is not stacked and torch.equal(restacked, torch.stack(layers))
    params = [torch.randn(64, 64, requires_grad=True) for _ in range(2)]
    grads = tk._stack(params)
    assert grads.requires_grad and tk._stack(params) is not grads
    with torch.no_grad():
        assert tk._stack(params) is tk._stack(params)
    with torch.inference_mode():
        frozen = torch.randn(2, 64, 64)
        assert tk.weight_slabs(frozen) is not tk.weight_slabs(frozen)


def test_tensor_cache_is_shared_safely_by_threads():
    """The daemon decodes from several threads: with more threads than
    cores, a cache smaller than the working set (so that entries are evicted
    all the time) and a short switch interval, every thread gets the value
    of its own tensors and no thread fails."""
    cache = tk._TensorCache(3)
    tensors = [torch.full((4,), float(i)) for i in range(8)]
    failures = []

    def work(seed):
        rng = np.random.default_rng(seed)
        try:
            for i in rng.integers(0, len(tensors), size=400):
                t = tensors[i]
                if not torch.equal(cache.get((t,), t.clone), t):
                    failures.append(int(i))
        except Exception as e:  # a lost update shows as a KeyError here
            failures.append(repr(e))

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4 * (os.cpu_count() or 1))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not failures, failures[:5]


def _setup(film, H, L, P, per_image, seed, B=2, N=5):
    cfg = JConfig(
        model_type="AutoDecoder", equivariance="SO2", latent_dim=N, hidden_layers=L,
        hidden_features=H, output_activation="tanh",
        conditioning="FiLM" if film else "Cond-by-Concat", mapping_layers=2,
        mapping_features=64,
    )
    jp = JModel(cfg).init(jax.random.PRNGKey(seed), dataset_size=B)
    rng = np.random.default_rng(seed + 1)
    Z = rng.normal(size=(B, N, 3)).astype(np.float32)
    D = rng.normal(size=(B if per_image else 1, P, 3)).astype(np.float32)
    D /= np.linalg.norm(D, axis=-1, keepdims=True)
    tp = tparams.from_numpy(jax.device_get(jp["decoder"]), "cpu")
    return cfg, jp["decoder"], tp, Z, D


# (H, H x H products): the fused route's widths at 1 to 5 products
ROUTE_SHAPES = ((64, 1), (128, 3), (256, 5))


@pytest.mark.parametrize("trunk", tk.TRUNKS)
@pytest.mark.parametrize("per_image", [False, True], ids=["shared", "per_image"])
@pytest.mark.parametrize("npix", [129, 200])
@pytest.mark.parametrize("hidden,n_mm", ROUTE_SHAPES)
@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_plain_forward_matches_pallas_at_the_route_shapes(
    film, hidden, n_mm, npix, per_image, trunk, monkeypatch
):
    """fused_apply / fused_film_apply on CPU tensors (the plain trunk)
    against the JAX package's fused_apply / fused_film_apply with the Pallas
    kernel in interpret mode, at shapes the JAX wrapper itself declines (H =
    64, P = 129: its TPU tiling), so its shape check is lifted and its tile
    is the whole pixel range. Bars: test_fused_bf16_trunk_close (bf16),
    1e-5 (float32)."""
    monkeypatch.setattr(jk, "unsupported_reason", lambda *args, **kwargs: None)
    monkeypatch.setattr(jk, "pick_tile", lambda npix, tile=512: npix)
    L = n_mm + 1 if film else n_mm
    cfg, jp, tp, Z, D = _setup(film, hidden, L, npix, per_image, seed=hidden + n_mm + npix)
    common = dict(hidden_layers=L, hidden_features=hidden, out_features=3,
                  output_activation="tanh", trunk=trunk)
    if film:
        ref = jk.fused_film_apply(jp, "SO2", jnp.asarray(Z), jnp.asarray(D), interpret=True,
                                  **common)
        out = tk.fused_film_apply(tp, "SO2", torch.from_numpy(Z), torch.from_numpy(D), **common)
    else:
        omegas = dict(first_omega_0=cfg.first_omega_0, hidden_omega_0=cfg.hidden_omega_0)
        ref = jk.fused_apply(jp, "SO2", cfg.latent_dim, jnp.asarray(Z), jnp.asarray(D),
                             interpret=True, **common, **omegas)
        out = tk.fused_apply(tp, "SO2", cfg.latent_dim, torch.from_numpy(Z),
                             torch.from_numpy(D), **common, **omegas)
    ref, out = np.asarray(ref), out.numpy()
    assert out.shape == ref.shape == (2, npix, 3)
    err = np.abs(out - ref)
    if trunk == "float32":
        assert err.max() < 1e-5, err.max()
    else:
        assert err.max() < 0.05 and err.mean() < 0.01, (err.max(), err.mean())
