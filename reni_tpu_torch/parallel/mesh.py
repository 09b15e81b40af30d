"""The data x pixel mesh (counterpart of ``reni_tpu/parallel/mesh.py``).

One rank is one device, so a mesh of ``n_data x n_pixel`` is that many ranks
(``WORLD_SIZE``). Rank ``r`` sits at ``(data, pixel) = divmod(r, n_pixel)``,
the row-major order of JAX's ``make_mesh``. Its block of a batch is its
``B / n_data`` rows (its data coordinate) and, where the pixel axis divides,
its ``P / n_pixel`` pixels; a pixel axis that does not divide is replicated,
and its partial sums then count on pixel coordinate 0 alone.

The JAX package's GSPMD program inserts the psums; here the stage runners
hand each step its block (``ShardView``, entered with ``kernel_mesh``) and
the step sums over the mesh itself, DDP-style:

- after the backward, one flat bucket of every replicated leaf's gradient
  and the step's loss partials is all-reduced over ``data x pixel``
  (``ShardView.reduce``). That gives JAX's sums: weight gradients reduce
  over both axes, and the replicated latent table's rows get their
  per-image gradients, which only the ranks holding the image's pixels have;
- a per-image term that is not linear in its pixels (the cosine over the
  pixel axis of FIT_LATENT and FIT_INVERSE) all-reduces its pixel sums over
  ``pixel`` in the forward and their gradients in the backward
  (``ShardView.pixel_sum``); per-image terms (KLD, the prior, the cosine)
  count on pixel coordinate 0 only;
- with ``shard_latents`` the latent tables and their optimizer moments are
  padded to the data axis and row-sharded over it for the stage
  (``shard_latent_tables``); a batch's rows come from their owners through
  one all-reduce over ``data`` and their gradients go back through one over
  ``data x pixel`` (``ShardView.latent_rows``).

A step makes at most four all-reduces, always in the same order, with no
float atomics, so two runs give the same bits and replicated parameters stay
bitwise equal on every rank. Device tensors cross ranks through
``all_reduce`` and ``broadcast`` only. The tensor-parallel ``model`` axis
(``_tp_spec``, ``shard_model`` in JAX) is ROADMAP Queue A-11b: a mesh with
``n_model > 1`` raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from reni_tpu_torch.params import tree_items

AXES = ("data", "pixel", "model")
_A11B = ("the tensor-parallel 'model' axis is not ported to reni_tpu_torch yet: "
         "ROADMAP Queue A-11b")


@dataclasses.dataclass(eq=False)
class Mesh:
    """A ('data', 'pixel', 'model') mesh seen from one rank: the axis sizes,
    this rank's coordinates, its device and the process groups of its
    ``data`` axis (the ranks of its pixel coordinate), its ``pixel`` axis
    (the ranks of its data coordinate) and of ``data x pixel``. Without
    groups (``Mesh(2, 2)``) it is a layout: it answers shape questions and
    takes part in no collective."""

    n_data: int = 1
    n_pixel: int = 1
    n_model: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    groups: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.n_model > 1:
            raise NotImplementedError(f"a mesh with model={self.n_model}: {_A11B}")
        self.data_index, self.pixel_index = divmod(self.rank, self.n_pixel)

    axis_names = AXES

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "pixel": self.n_pixel, "model": self.n_model}

    @property
    def size(self) -> int:
        return self.n_data * self.n_pixel

    def group(self, axis: str):
        """The process group of ``axis`` ('data', 'pixel' or 'all'), or None
        where no collective is needed (one rank on it, or a layout)."""
        n = {"data": self.n_data, "pixel": self.n_pixel, "all": self.size}[axis]
        return self.groups.get(axis) if n > 1 else None

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
    """The mesh of this run's ranks: ``n_data x n_pixel`` must be the world
    size (``n_data=-1``: the world size over ``n_pixel``). Every rank calls
    it, in the same order as the other collectives: it makes the process
    groups. ``device`` is this rank's (``multihost.rank_device``)."""
    from reni_tpu_torch.parallel import multihost

    if n_model > 1:
        raise NotImplementedError(f"--mesh with model={n_model}: {_A11B}")
    world = multihost.process_count()
    if n_data == -1:
        if world % n_pixel:
            raise ValueError(f"WORLD_SIZE {world} does not divide over pixel={n_pixel}")
        n_data = world // n_pixel
    if n_data * n_pixel != world:
        raise ValueError(f"a mesh of data={n_data} x pixel={n_pixel} = {n_data * n_pixel} "
                         f"ranks, but WORLD_SIZE is {world}: one rank is one device")
    rank = multihost.process_index()
    groups = {}
    if dist.is_initialized():
        # new_group is collective over the world: every rank makes every
        # group, in this order, and keeps its own
        for p in range(n_pixel):
            g = dist.new_group([d * n_pixel + p for d in range(n_data)])
            if rank % n_pixel == p:
                groups["data"] = g
        for d in range(n_data):
            g = dist.new_group([d * n_pixel + p for p in range(n_pixel)])
            if rank // n_pixel == d:
                groups["pixel"] = g
        groups["all"] = dist.group.WORLD
    return Mesh(n_data, n_pixel, 1, rank, multihost.rank_device(device), groups)


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
        rows' gradients over ``data x pixel`` back to the owners."""
        rows = self.rows(idx.shape[0])
        if not any(self.is_sharded(t) for t in tables):
            return [t[idx[rows]] for t in tables]
        R = tables[0].shape[0]
        lo = self.mesh.data_index * R
        own = (idx >= lo) & (idx < lo + R)
        local = torch.clamp(idx - lo, 0, R - 1)
        buf = torch.cat([t[local] * own[:, None, None].to(t.dtype) for t in tables], dim=-1)
        full = _AllReduce.apply(buf, self.mesh.group("data"), self.mesh.group("all"))[rows]
        k = tables[0].shape[-1]
        return [full[..., i * k : (i + 1) * k] for i in range(len(tables))]

    def reduce(self, params: list[torch.Tensor], metrics: dict) -> dict:
        """The step's one bucket: the gradients of ``params`` that are not
        row-sharded and the metric partials, summed over ``data x pixel``.
        Returns the summed metrics."""
        grads = [p.grad for p in params if p.grad is not None and not self.is_sharded(p)]
        names = list(metrics)
        vals = torch.stack([metrics[k].detach() for k in names])
        all_reduce_sum(grads + [vals], self.mesh.group("all"))
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


def state_sharding(mesh: Mesh, tree, shard_latents: bool = False,
                   shard_model: bool | None = None) -> dict:
    """{path: spec} of a parameter tree: every leaf replicated (``()``),
    except, with ``shard_latents``, the latent tables, row-sharded over
    'data' (``("data", None, None)``). A table whose rows do not divide the
    data axis raises: pad it first (``pad_latent_rows``; the runners do).
    ``shard_model`` (the 'model' axis) is ROADMAP Queue A-11b."""
    if shard_model:
        raise NotImplementedError(f"state_sharding(shard_model=True): {_A11B}")
    out = {}
    for path, leaf in tree_items(tree):
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
    (``ShardView`` picks its rows), and the latent tables row-sharded for
    the stage with ``shard_latents``."""
    from reni_tpu_torch.train import tasks as _tasks

    def run_stage(step_fn, state, images, n_epochs, batch_size):
        batch_size = pad_batch_to(batch_size, mesh.n_data)
        idx, bmask = _tasks.make_batches(images.shape[0], batch_size)
        imgs, idx_b, bmask_b = shard_stage_data(mesh, images, idx, bmask.astype(np.float32))
        bmask_b = bmask_b.to(imgs.dtype)
        rows = mesh.rows(batch_size)
        gather = shard_latent_tables(state, mesh) if shard_latents else None
        epochs = []
        with kernel_mesh(mesh, images.shape[1], getattr(gather, "sharded", ())):
            for _ in range(n_epochs):
                ms = []
                for b in range(idx_b.shape[0]):
                    state, m = step_fn(state, (imgs[idx_b[b, rows]], idx_b[b], bmask_b[b]))
                    ms.append(m)
                epochs.append({k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]})
        if gather is not None:
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

