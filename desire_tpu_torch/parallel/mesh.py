"""The ``(data, k)`` device mesh as ``torch.distributed`` (PyTorch port of
``desire_tpu/parallel/mesh.py``).

One process per mesh device: the process of rank ``d * mesh_k + k`` holds
mesh position ``(d, k)``.

* ``data``: batch rows (data parallel). A rank holds block ``d`` of every
  global batch (:func:`local_batch_rows`) and a full copy of the params;
  training sums its gradients over the ``data`` group.
* ``k``: hypothesis lanes. A rank samples and refines block ``k`` of the K
  lanes of its rows.

What the JAX package states by annotation, per-rank code does explicitly,
so two of its functions have no counterpart here. ``batch_sharding`` and
``replicated`` say where GSPMD puts an array: here a rank simply holds its
row block and its copy of the params. ``sharding.shard_hint`` likewise;
its layouts are realised where the port cuts the block:

* rows (``desire_tpu/models/desire.py:67-68``): ``models/desire.py``
  ``_meshed_forward`` cuts the rank's rows where the batch enters, and
  ``train/trainer.run_epoch`` has the loader assemble only those rows;
* lanes (``desire_tpu/models/sgm.py:530-531``, the fused sampler's raw
  and dec_h): ``ops/sgm_fused.sgm_sample_decode_sharded`` launches on the
  rank's lanes of eps;
* lanes (``desire_tpu/models/sgm.py:599`` and ``:617-618``, z and the
  layer-by-layer decoder's raw and dec_h): ``models/sgm.sgm_forward`` cuts
  the lanes of eps before the decoder.

Collectives are only ``broadcast``, ``all_reduce`` and ``barrier``: the
three that gloo runs on CUDA tensors, and what NCCL runs where every rank
has a card of its own (NCCL refuses two ranks on one card). A gather is
the sum of a zero-filled global tensor into which each rank wrote its
block (:func:`assemble`), exact since every element has one writer.
Lane-parallel training gathers the IOC's lane blocks differentiably
(:func:`gather_lanes`).
"""

from __future__ import annotations

import dataclasses
import datetime
import math

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
K_AXIS = "k"
# every axis: a group of the mesh's ranks
MESH = (DATA_AXIS, K_AXIS)

_TIMEOUT_S = 1800.0


def init_multihost(coordinator: str | None, num_processes: int | None,
                   process_id: int | None, device="cuda",
                   timeout_s: float = _TIMEOUT_S) -> None:
    """Join the process group of a multi-process run; a no-op when
    ``coordinator`` ("host:port", where rank 0 listens) is empty.

    The backend is NCCL where every rank has a card of its own, gloo on the
    CPU and where ranks share a card. Every collective waits at most
    ``timeout_s`` seconds for the other ranks."""
    if not coordinator:
        return
    device = torch.device(device)
    backend = "gloo"
    if device.type == "cuda" and num_processes <= torch.cuda.device_count():
        backend = "nccl"
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a ``(data, k)`` mesh: the mesh's shape, the
    rank's coordinates and device, and one process group per axis (the
    ranks that differ from this one only along it) and one of the whole
    mesh (``MESH``); None where the run has one process."""
    shape: tuple[int, int]
    coords: tuple[int, int]
    device: torch.device
    groups: dict

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    def rows(self, n: int) -> slice:
        """This rank's contiguous block of n rows split over ``data``."""
        return _block(n, self.shape[0], self.coords[0], "rows", DATA_AXIS)

    def lanes(self, k: int) -> slice:
        """This rank's contiguous block of k lanes split over ``k``."""
        return _block(k, self.shape[1], self.coords[1], "lanes", K_AXIS)

    def divides(self, b: int, k: int) -> bool:
        """Whether b rows and k lanes split evenly over the mesh."""
        return b % self.shape[0] == 0 and k % self.shape[1] == 0


def _block(n, parts, index, what, axis):
    if n % parts:
        raise ValueError(f"{n} {what} do not split over the {axis} axis of "
                         f"{parts}")
    size = n // parts
    return slice(index * size, (index + 1) * size)


def make_mesh(data: int | None = None, k: int = 1, device="cuda",
              timeout_s: float = _TIMEOUT_S) -> Mesh | None:
    """Build the ``(data, k)`` mesh over the first ``data * k`` ranks of
    the process group; data=None takes every rank. Collective: every rank
    calls it. A rank beyond the mesh gets None and takes no part in its
    collectives. device: "cuda" (rank r on ``cuda:{r % device count}``)
    or "cpu"."""
    n = process_count()
    if data is None:
        assert n % k == 0, f"{n} devices not divisible by k={k}"
        data = n // k
    assert data * k <= n, f"mesh {data}x{k} exceeds {n} devices"
    rank = process_index()
    groups = {DATA_AXIS: None, K_AXIS: None, MESH: None}
    if n > 1:
        # every rank creates every group, in the same order; an axis of one
        # rank needs none
        by_k = [[d * k + j for d in range(data)] for j in range(k)]
        by_d = [[d * k + j for j in range(k)] for d in range(data)]
        for key, ranks in ((DATA_AXIS, by_k), (K_AXIS, by_d),
                           (MESH, [list(range(data * k))])):
            if len(ranks[0]) == 1:
                continue
            if len(ranks[0]) == n:
                groups[key] = dist.group.WORLD
                continue
            for r in ranks:
                g = dist.new_group(
                    r, timeout=datetime.timedelta(seconds=timeout_s))
                if rank in r:
                    groups[key] = g
    if rank >= data * k:
        return None
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh((data, k), (rank // k, rank % k), device, groups)


def local_batch_rows(mesh: Mesh, global_batch: int) -> np.ndarray:
    """This rank's rows of a global batch, ascending: the contiguous block
    that JAX's ``P('data')`` gives mesh device ``(d, ·)``."""
    s = mesh.rows(global_batch)
    return np.arange(s.start, s.stop, dtype=np.int64)


def _axis_size(mesh: Mesh, axis) -> int:
    if axis == MESH:
        return mesh.size
    return mesh.shape[0] if axis == DATA_AXIS else mesh.shape[1]


def all_sum(mesh: Mesh, x: torch.Tensor, axis=DATA_AXIS) -> torch.Tensor:
    """x summed over the ranks of ``axis`` (DATA_AXIS, K_AXIS or MESH), a
    new tensor on every one of them (x itself where the axis has one
    rank). bfloat16 and float16 are summed in float32."""
    if _axis_size(mesh, axis) == 1:
        return x
    wide = x.detach().to(torch.float32 if x.dtype in (
        torch.bfloat16, torch.float16) else x.dtype).clone()
    dist.all_reduce(wide, group=mesh.groups[axis])
    return wide.to(x.dtype)


def _sum_gather(mesh: Mesh, axis, pieces) -> list:
    """Place each block at its index of a zero-filled float32 buffer of its
    global shape and sum the buffers over ``axis``, in one all-reduce:
    exact, since every element has one writer. pieces: (block, global
    shape, index) triples. Returns the global tensors, float32 views of
    one buffer."""
    sizes = [math.prod(shape) for _, shape, _ in pieces]
    flat = torch.zeros(sum(sizes), dtype=torch.float32, device=mesh.device)
    for seg, (block, shape, idx) in zip(flat.split(sizes), pieces):
        seg.view(shape)[idx] = block
    dist.all_reduce(flat, group=mesh.groups[axis])
    return [seg.view(shape)
            for seg, (_, shape, _) in zip(flat.split(sizes), pieces)]


def assemble(mesh: Mesh, blocks, lane_dim: int | None = None) -> list:
    """Gather blocks into their global tensors on every rank, in one
    all-reduce. blocks: (block, global shape) pairs, this rank's rows on
    dim 0 and, with ``lane_dim``, its lanes on that dim (gathered over the
    whole mesh; without, over ``data``, since the ranks of one ``data``
    coordinate hold the same rows)."""
    axis = DATA_AXIS if lane_dim is None else MESH
    if _axis_size(mesh, axis) == 1:
        return [b for b, _ in blocks]
    pieces = []
    for block, shape in blocks:
        idx = [mesh.rows(shape[0])]
        if lane_dim is not None:
            idx += [slice(None)] * (lane_dim - 1) + [mesh.lanes(
                shape[lane_dim])]
        pieces.append((block, shape, tuple(idx)))
    return [x.to(block.dtype) for x, (block, _) in
            zip(_sum_gather(mesh, axis, pieces), blocks)]


class _LaneGather(torch.autograd.Function):
    """Forward: the rank's lane blocks gathered to their K lanes over the
    ``k`` group (:func:`_sum_gather`). Backward: mk times the rank's own
    lanes of each upstream gradient."""

    @staticmethod
    def forward(ctx, mesh, dims, *blocks):
        mk = mesh.shape[1]
        ctx.mesh, ctx.dims = mesh, dims
        ctx.widths = [x.shape[d] for x, d in zip(blocks, dims)]
        pieces = []
        for x, d in zip(blocks, dims):
            shape = list(x.shape)
            shape[d] *= mk
            idx = (slice(None),) * d + (mesh.lanes(shape[d]),)
            pieces.append((x, shape, idx))
        return tuple(y.to(x.dtype, copy=True) for y, x in
                     zip(_sum_gather(mesh, K_AXIS, pieces), blocks))

    @staticmethod
    def backward(ctx, *grads):
        mk = ctx.mesh.shape[1]
        out = []
        for g, d, w in zip(grads, ctx.dims, ctx.widths):
            start = ctx.mesh.lanes(w * mk).start
            out.append(g.narrow(d, start, w) * mk)
        return (None, None, *out)


def gather_lanes(mesh: Mesh, blocks) -> list:
    """Gather lane blocks to their full K lanes on every rank of the
    rank's ``k`` group, differentiably. blocks: (block, lane dim) pairs,
    the rank's lanes (``mesh.lanes``) on that dim; the rows are the same
    on every rank of the group. One all-reduce of a zero-filled float32
    buffer, exact since every element has one writer (bfloat16 and
    float32 blocks come back bit for bit).

    The backward gives each block mk times the rank's own lanes of the
    upstream gradient, with no collective. Every ``k`` rank of a ``data``
    row computes the same loss from the same gathered tensors and the same
    replicated rows, so its upstream gradient is the same, and mk times a
    rank's share summed over the ``k`` group is mk times the reduce-scatter
    of the gradient: the training step's one all-reduce of the gradients
    over the mesh, divided by mk (``train.trainer``), then gives every
    rank the unsharded gradient. Where two ranks' upstream gradients
    differ in rounding (a kernel whose float sums have no fixed order),
    the result differs from the unsharded one by that rounding, and every
    rank still gets the same gradient from that all-reduce, so the params
    stay equal: the exact reduce-scatter (one more all-reduce in every
    backward) would buy nothing more."""
    if mesh.shape[1] == 1:
        return [b for b, _ in blocks]
    return list(_LaneGather.apply(mesh, tuple(d for _, d in blocks),
                                  *(b for b, _ in blocks)))


def on_lanes(mesh: Mesh, fn, traj: torch.Tensor, dec_h: torch.Tensor,
             dims) -> list:
    """fn(traj, dec_h) on the rank's lanes of both (dim 2, ``mesh.lanes``),
    its outputs gathered to all K lanes (:func:`gather_lanes`). fn returns
    a sequence of tensors whose lane dims are ``dims``, one each; its other
    inputs must be per lane independent of the lanes it is not given."""
    ln = mesh.lanes(traj.shape[2])
    outs = fn(traj[:, :, ln], dec_h[:, :, ln])
    return gather_lanes(mesh, list(zip(outs, dims)))


def broadcast(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The mesh's rank 0's x, in place, on every rank of the mesh."""
    if mesh.size > 1:
        dist.broadcast(x, src=0, group=mesh.groups[MESH])
    return x


def barrier(mesh: Mesh | None) -> None:
    """Wait for every rank of the mesh (nothing to wait for without one)."""
    if mesh is not None and mesh.size > 1:
        dist.barrier(group=mesh.groups[MESH])
