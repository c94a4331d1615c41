"""The process mesh for multi-device rendering and training, on
``torch.distributed`` (the JAX package's ``parallel/mesh.py``).

The layout is JAX's 2D mesh of ranks:

  'dp'  data parallel over pixels: each member renders its tile of the
        image, and the frame is assembled by an all-reduce SUM of a zero
        frame into which each member has written its tile;
  'tp'  parallel over primitives: each member intersects its shard of the
        sphere and triangle tables and the closest hit is combined by MIN
        reductions (``parallel/intersect.py``).

Rank r sits at (dp index r // tp, tp index r % tp).  Its 'tp' group holds
the ranks of its dp row, its 'dp' group the ranks of its tp column.

Every collective the port makes is an ``all_reduce`` (MIN, SUM) or a
``broadcast``: a machine with one card runs several ranks through gloo over
CUDA tensors, and gloo offers only those two on GPU tensors.

The backend follows one rule (``choose_backend``): NCCL when each rank has
a card of its own, gloo when ranks share one card or run on the CPU.  The
choice is printed, and it is never swapped after a failure.

``spawn`` runs a function on N local ranks (the spawn start method: the
function must live in an importable module) and returns each rank's
result; a rank that raises fails the call.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device

Tensor = torch.Tensor


def choose_backend(world_size: int, device) -> str:
    """'nccl' when every local rank can have a CUDA card of its own, else
    'gloo' (ranks sharing one card, or the CPU)."""
    device = torch.device(device)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if device.type == "cuda" and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def init_distributed(rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     init_method: Optional[str] = None,
                     backend: Optional[str] = None,
                     device=None) -> torch.device:
    """Join the process group and return this rank's device.

    With no rank given, the rank, world size and rendezvous come from the
    environment (``env://``, as ``torchrun`` sets them); otherwise pass all
    three (a ``file://`` or ``tcp://`` rendezvous).  device: the device
    kind the ranks render on (None: the CUDA card, raising without one).
    Under NCCL each rank takes card LOCAL_RANK; under gloo the ranks share
    the given device."""
    if rank is None:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        init_method = "env://"
    device = resolve_device(device)
    backend = backend or choose_backend(world_size, device)
    if device.type == "cuda":
        index = (int(os.environ.get("LOCAL_RANK", rank))
                 if backend == "nccl" else (device.index or 0))
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    print(f"[mesh] rank {rank} of {world_size}: backend {backend} on "
          f"{device}", flush=True)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ('dp', 'tp') mesh of ranks and this rank's place in it.  The
    groups are None on a one-rank mesh made without a process group (its
    collectives are the identity)."""

    dp: int
    tp: int
    rank: int
    dp_group: object = None
    tp_group: object = None

    @property
    def size(self) -> int:
        return self.dp * self.tp

    @property
    def dp_index(self) -> int:
        return self.rank // self.tp

    @property
    def tp_index(self) -> int:
        return self.rank % self.tp

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    def axis_size(self, axis: str) -> int:
        return {"dp": self.dp, "tp": self.tp}[axis]

    def group(self, axis: str):
        return {"dp": self.dp_group, "tp": self.tp_group}[axis]


def make_mesh(n_devices: Optional[int] = None, tp: int = 1) -> Mesh:
    """A ('dp', 'tp') mesh over the n ranks of the process group
    (mesh.py:46).  Every rank must call it, with the same arguments, in the
    same order as its other group creations.  Without a process group only
    n = 1 is possible."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    assert n_devices % tp == 0, f"{n_devices} devices not divisible by tp={tp}"
    dp = n_devices // tp
    if not dist.is_initialized():
        assert n_devices == 1, (
            f"a mesh of {n_devices} ranks needs torch.distributed initialized "
            "(parallel.mesh.init_distributed or spawn)")
        return Mesh(1, 1, 0)
    world = dist.get_world_size()
    assert n_devices == world, (
        f"a mesh of {n_devices} ranks in a process group of {world}")
    dp_groups = [dist.new_group([d * tp + t for d in range(dp)])
                 for t in range(tp)]
    tp_groups = [dist.new_group([d * tp + t for t in range(tp)])
                 for d in range(dp)]
    rank = dist.get_rank()
    return Mesh(dp, tp, rank, dp_groups[rank % tp], tp_groups[rank // tp])


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0,
                    fill=None) -> np.ndarray:
    """Pad ``axis`` to a multiple (mesh.py:60); the pad replicates row 0
    unless ``fill`` is given."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x
    pad_shape = list(x.shape)
    pad_shape[axis] = rem
    if fill is None:
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(0, 1)
        pad = np.broadcast_to(np.asarray(x[tuple(idx)]), pad_shape)
    else:
        pad = np.full(pad_shape, fill, dtype=x.dtype)
    return np.concatenate([np.asarray(x), pad], axis=axis)


def pad_rows(x: Tensor, multiple: int, axis: int = 0) -> Tensor:
    """``pad_to_multiple``'s row-0 padding for a tensor."""
    rem = (-x.shape[axis]) % multiple
    if rem == 0:
        return x
    first = x.narrow(axis, 0, 1)
    shape = list(x.shape)
    shape[axis] = rem
    return torch.cat([x, first.expand(shape)], dim=axis)


def all_reduce(x: Tensor, op, group) -> Tensor:
    """x reduced over ``group`` (a new tensor; no gradient), or x itself
    when the group is None."""
    if group is None:
        return x
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=group)
    return y


def pmean(x: Tensor, mesh: Mesh, axes: Sequence[str]) -> Tensor:
    """The mean of x over the named axes, one axis after another (JAX's
    nested ``pmean``)."""
    for axis in axes:
        x = all_reduce(x, dist.ReduceOp.SUM, mesh.group(axis)) \
            / mesh.axis_size(axis)
    return x


# ---------------------------------------------------------------------------
# Local ranks
# ---------------------------------------------------------------------------

def _rank_main(rank: int, fn: Callable, world_size: int, init_method: str,
               device, backend: Optional[str], out_dir: str, threads: int,
               args: tuple) -> None:
    if threads:
        torch.set_num_threads(threads)
    dev = init_distributed(rank, world_size, init_method, backend, device)
    try:
        out = fn(dev, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, args: tuple = (), device=None,
          backend: Optional[str] = None, threads: int = 0) -> list:
    """Run ``fn(device, *args)`` on ``world_size`` local ranks, each in a
    process group of its own making (a ``file://`` rendezvous in a fresh
    temporary directory), and return the ranks' results in rank order
    (each saved with torch.save, so keep them on the CPU).  ``fn`` must be
    importable by name (the spawn start method re-imports it).  device:
    the ranks' device kind (None: the CUDA card); on CUDA the parent
    builds the kernels first, so the ranks only load them.  threads: the
    ranks' intra-op threads (0 leaves torch's default).  A rank that
    raises makes this raise, after the others are stopped."""
    device = resolve_device(device)
    if device.type == "cuda":
        from ..ops import _cuda
        _cuda.build()
    out_dir = tempfile.mkdtemp(prefix="crt_spawn_")
    try:
        init_method = "file://" + os.path.join(out_dir, "rendezvous")
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world_size, init_method, str(device),
                              backend, out_dir, threads, tuple(args)),
            nprocs=world_size, join=True, start_method="spawn")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world_size)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
