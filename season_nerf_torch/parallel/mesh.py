"""Device mesh for data parallelism: the counterpart of
``season_nerf_tpu/parallel/mesh.py``.

Rays are independent and the network is small, so the mesh splits the
ray batch and replicates everything else:

  batch rows   [B, ...]  -> each rank its contiguous B / n rows
  params/opt             -> replicated, stepped alike on every rank
  ray table              -> replicated on every device
  draws                  -> every rank draws the global batch's and keeps
                            its rows

Training runs one process per device (:func:`launch`) over
``torch.distributed``: NCCL for cards, gloo for the CPU.  The step is the
global-batch step that GSPMD gives the JAX package: BatchNorm statistics
and batch means over the whole batch, gradients summed over the ranks.  A
process learns its place from the :class:`Mesh` it is handed (``rank``
and ``group`` set); the collectives below are autograd functions, so the
BatchNorm statistics and the global minimum carry their gradients back to
the ranks that hold their inputs.

Rendering runs in one process: the renderer splits every chunk over the
mesh's devices, one replica of the model on each, and needs no collective
(``render/renderer.py``).  A mesh may name one device more than once (two
replicas on one card, or ranks sharing the CPU).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=30)    # a rank waits this long in a
#                                             collective (rank 0 validates
#                                             while the others wait)


@dataclasses.dataclass
class Mesh:
    """The devices of a 1-D data mesh.  In a training rank's process also
    its ``rank`` and the ``group`` of the ranks (``torch.distributed``);
    ``group`` None: the devices of one process (the render mesh, or the
    mesh :func:`launch` is asked to start ranks on)."""
    devices: List[torch.device]
    rank: int = 0
    group: Optional[object] = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.devices[self.rank]


def visible_devices(device="cuda") -> List[torch.device]:
    """The devices of ``device``'s type a mesh may take: every card for
    ``cuda``, one CPU for ``cpu``."""
    if torch.device(device).type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _indexed(device) -> torch.device:
    """``device`` with its card's index (``cuda`` is the current card)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device()
                         if torch.cuda.is_initialized() else 0)
    return d


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A mesh over ``devices`` (default: every visible card, or the CPU
    where there is none), cut to the first ``n_devices``; more than there
    are raises."""
    if devices is None:
        devices = visible_devices("cuda" if torch.cuda.is_available()
                                  else "cpu")
    devices = [_indexed(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"make_mesh: asked for {n_devices} devices but only "
                f"{len(devices)} visible ({devices[0].type}); refusing "
                "to silently build a smaller mesh")
        devices = devices[:n_devices]
    return Mesh(devices)


def batch_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous rows of an ``n``-row global batch."""
    if n % mesh.size:
        raise ValueError(f"a batch of {n} rows does not split over the "
                         f"{mesh.size}-device mesh")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def replicated_sharding(mesh: Mesh) -> torch.device:
    """Where a replicated tensor lives in this rank: whole, on its
    device."""
    return mesh.device


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a global batch (a tensor or a dict of tensors
    sharing their first dimension), on its device."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    return batch[batch_sharding(mesh, batch.shape[0])].to(mesh.device)


# --- collectives -------------------------------------------------------------
class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks.  Each rank's input enters every rank's sum,
    so its gradient is the sum of every rank's output gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    """Every rank's input stacked [ranks, ...], as a sum of zero-padded
    slots (one all-reduce: every backend takes it, CUDA tensors on gloo
    too).  What consumes the gather is replicated (every rank computes the
    same function of it), so each rank's gradient for its own slot is
    already the whole gradient: the slot is taken, not summed."""

    @staticmethod
    def forward(ctx, x, rank, size, group):
        ctx.rank = rank
        slots = x.new_zeros((size,) + tuple(x.shape))
        slots[rank] = x
        dist.all_reduce(slots, group=group)
        return slots

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank], None, None, None


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``x`` summed over the mesh's ranks (``x`` itself without a mesh)."""
    if mesh is None:
        return x
    return _AllReduceSum.apply(x, mesh.group)


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` stacked along a new first dimension, in rank
    order; for a replicated consumer (see :class:`_AllGather`)."""
    return _AllGather.apply(x, mesh.rank, mesh.size, mesh.group)


def global_amin(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The minimum over the first dimension of the global batch, ``x``
    being this rank's rows; its gradient reaches the rank holding it."""
    local = torch.amin(x, dim=0)
    if mesh is None:
        return local
    return torch.amin(all_gather(local, mesh), dim=0)


def all_reduce_grads(tensors, mesh: Mesh):
    """Sum the gradients of ``tensors`` over the ranks in place, in one
    flat all-reduce; tensors without a gradient are passed over (the same
    on every rank: every rank builds the same graph)."""
    grads = [t.grad for t in tensors if t.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def barrier(mesh: Mesh):
    """Wait until every rank arrives."""
    if dist.get_backend(mesh.group) == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)


# --- the launcher ------------------------------------------------------------
def _rank_main(rank, fn, devices, backend, store, threads, args):
    torch.set_num_threads(threads)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{store}/store",
                            rank=rank, world_size=len(devices),
                            timeout=TIMEOUT)
    try:
        mesh = Mesh([torch.device(d) for d in devices], rank,
                    dist.group.WORLD)
        out = fn(mesh, *args)
        torch.save(out, os.path.join(store, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def backend_for(mesh: Mesh) -> str:
    """The ``torch.distributed`` backend of ``mesh``'s ranks: NCCL where
    its devices are distinct cards, else gloo (NCCL takes one rank a card;
    gloo takes CUDA tensors too, so ranks may share a card)."""
    cards = all(d.type == "cuda" for d in mesh.devices)
    distinct = len(set(mesh.devices)) == mesh.size
    return "nccl" if cards and distinct else "gloo"


def launch(fn: Callable, mesh: Mesh, *args) -> list:
    """Run ``fn(rank_mesh, *args)`` in one process per device of ``mesh``
    over :func:`backend_for`'s backend -> what each rank returned, in rank
    order.

    ``fn`` must be importable by name (the processes are spawned, so each
    imports the module that defines it); ``args`` are pickled, tensors by a
    handle to shared memory, so a large CPU tensor (the ray table) is not
    copied per rank.  The ranks meet through a file store in a temporary
    directory; a rank's CPU threads are this process's divided among the
    ranks.  A rank that raises ends the others and raises here."""
    devices = [str(d) for d in mesh.devices]
    backend = backend_for(mesh)
    threads = max(1, torch.get_num_threads() // mesh.size)
    with tempfile.TemporaryDirectory() as store:
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, devices, backend, store, threads, args),
            nprocs=mesh.size, join=True)
        return [torch.load(os.path.join(store, f"rank{r}.pt"),
                           weights_only=False) for r in range(mesh.size)]
