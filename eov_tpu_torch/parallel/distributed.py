"""Launch and collectives for multi-GPU jobs: one process per GPU.

Counterpart of ``eov_tpu/parallel/distributed.py``. The reference runs one
multi-controller JAX process per host, driving every local chip; the port
follows PyTorch's idiom instead: one process per GPU, launched by
``torchrun`` (``python -m torch.distributed.run --nproc_per_node N``),
each rank on ``cuda:LOCAL_RANK``.

``initialize`` covers the reference's three cases: explicit arguments
(tests, ``chip_smoke.py``), a launcher's environment (torchrun's ``RANK``
/ ``WORLD_SIZE`` / ``MASTER_ADDR`` ..., or ``EOV_MULTIHOST=1``; the group
is initialized there even at a world of 1, as the reference initializes
for an explicit coordinator), and neither (nothing to do). The backend is
``nccl`` for CUDA and ``gloo`` for the CPU unless the caller names one;
NCCL with more ranks on a host than it has GPUs is refused. A rank never
moves to the CPU on its own, and no collective failure is caught.

The collectives take a process group of a ``parallel.mesh.Mesh`` (None =
the whole world) and are the identity without an initialized group or on
a group of one. Each stages its tensor where the backend takes it
(``collective_device``): under gloo a CUDA tensor goes through the host
(the ranks' compute stays on their GPUs; only the collective runs on the
CPU), under NCCL a host tensor (a step count, a clip mask) goes to the
rank's GPU.
``all_reduce_grad`` is a sum whose backward is the same sum, so autograd
carries a cross-rank reduction (the trained BN's statistics, the frame
consensus) into the backward.

The reference's ``host_batch_to_global`` has no counterpart: each rank
already holds exactly its rows of the global batch, and ``host_local_rows``
names which.
"""

from __future__ import annotations

import logging
import os
from typing import Sequence

import torch
import torch.distributed as dist

from eov_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["launcher_env_detected", "initialize", "local_device",
           "global_mesh", "process_record_shard", "host_local_rows",
           "host_local_frames", "global_max", "barrier", "broadcast_object",
           "broadcast_tensors", "all_reduce", "all_reduce_grad",
           "all_gather", "collective_device", "world_size", "rank"]

log = logging.getLogger("eov_tpu_torch.distributed")

_LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def launcher_env_detected() -> bool:
    """True when a launcher's environment says this process is a rank
    (torchrun's variables), or ``EOV_MULTIHOST=1`` forces it."""
    env = os.environ
    return bool(env.get("EOV_MULTIHOST")) or all(v in env
                                                  for v in _LAUNCHER_VARS)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_device(device: torch.device | str = "cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for a CUDA request without
    an index (0 without a launcher), the CPU as asked."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def initialize(backend: str | None = None, *, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               device: torch.device | str | None = None) -> bool:
    """Initialize the default process group; returns whether one is up.
    Idempotent.

    * explicit ``world_size`` and ``rank`` (with ``init_method``, e.g.
      ``tcp://localhost:PORT`` or ``file://PATH``): forwarded;
    * a launcher's environment (``launcher_env_detected``): ``env://``;
    * neither: nothing to do (a world of one, no group).

    ``backend`` defaults to ``nccl`` when ``device`` is CUDA (CUDA when
    None and a GPU is visible) and to ``gloo`` otherwise.
    """
    if dist.is_initialized():
        return True
    explicit = world_size is not None or rank is not None
    if explicit and (world_size is None or rank is None):
        raise ValueError("explicit initialization needs both world_size "
                         "and rank")
    if not explicit and not launcher_env_detected():
        return False
    if explicit and not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is outside a world of {world_size}")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = local_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        n_gpu = torch.cuda.device_count() if torch.cuda.is_available() else 0
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size
                                   if explicit else
                                   os.environ.get("WORLD_SIZE", 1)))
        if local > n_gpu:
            raise ValueError(
                f"backend='nccl' needs one GPU per rank: {local} ranks on "
                f"this host, {n_gpu} visible GPU(s). NCCL refuses two ranks "
                "on one device; use backend=\"gloo\" to share a GPU (or run "
                "on the CPU)")
        torch.cuda.set_device(dev)
    kwargs = {}
    if explicit:
        kwargs = {"world_size": world_size, "rank": rank}
    dist.init_process_group(backend, init_method=init_method or (
        None if explicit else "env://"), **kwargs)
    log.info("process group up: rank %d of %d, backend %s, device %s",
             dist.get_rank(), dist.get_world_size(), backend, dev)
    return True


def global_mesh(n_frame: int = 1) -> Mesh:
    """('data', 'frame') mesh over every rank of the world."""
    return make_mesh(n_frame=n_frame)


def process_record_shard(records: Sequence, mesh: Mesh | None = None) -> list:
    """The records of this rank's data row (strided assignment by the data
    index, so the frame ranks of one row decode the same records).

    Striding keeps the rows balanced when clip durations correlate with
    dataset order."""
    if mesh is None:
        mesh = global_mesh()
    return list(records[mesh.data_index::mesh.n_data])


def host_local_rows(mesh: Mesh, n_global: int) -> slice:
    """The rows of a global batch of ``n_global`` clips this rank holds:
    its data row's contiguous block."""
    if n_global % mesh.n_data:
        raise ValueError(f"global batch of {n_global} not divisible by "
                         f"data={mesh.n_data}")
    b = n_global // mesh.n_data
    return slice(mesh.data_index * b, (mesh.data_index + 1) * b)


def host_local_frames(mesh: Mesh, k_global: int) -> slice:
    """The segments of a ``k_global``-segment clip this rank holds."""
    if k_global % mesh.n_frame:
        raise ValueError(f"{k_global} segments not divisible by "
                         f"frame={mesh.n_frame}")
    k = k_global // mesh.n_frame
    return slice(mesh.frame_index * k, (mesh.frame_index + 1) * k)


def _size(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def collective_device(t: torch.Tensor, group=None) -> torch.device:
    """Where the group's backend runs ``t``'s collective: gloo on the host,
    NCCL on this rank's GPU (it refuses host tensors), any other backend
    where ``t`` lies."""
    backend = dist.get_backend(group)
    if backend == "gloo":
        return torch.device("cpu")
    if backend == "nccl" and not t.is_cuda:
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` on ``collective_device`` (a copy when it must move)."""
    dev = collective_device(t, group)
    return t.contiguous() if dev == t.device else t.to(dev)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def all_reduce(t: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """The reduction of ``t`` over ``group`` (a new tensor on t's device;
    ``t`` itself when the group has one rank)."""
    if _size(group) == 1:
        return t
    buf = _staged(t, group)
    buf = buf.clone() if buf is t else buf
    dist.all_reduce(buf, op=_OPS[op], group=group)
    return buf.to(t.device)


class _AllReduceGrad(torch.autograd.Function):
    """Sum over the group; the backward sums the output gradients over the
    group (each rank's loss reads the same total)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


def all_reduce_grad(t: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of ``t`` over ``group``."""
    if _size(group) == 1:
        return t
    return _AllReduceGrad.apply(t, group)


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """The group's tensors concatenated along dim 0, in group rank order."""
    n = _size(group)
    if n == 1:
        return t
    buf = _staged(t, group)
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts).to(t.device)


def global_max(value: int) -> int:
    """Max of a rank-local int over the world (identity without a group).

    Agrees a step count when ranks hold different numbers of records:
    every rank must enter the same number of collectives or the job
    deadlocks."""
    return int(all_reduce(torch.tensor([int(value)], dtype=torch.int64),
                          op="max").item())


def barrier() -> None:
    """Cross-rank sync point (no-op without a group)."""
    if dist.is_initialized():
        dist.barrier()


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` on every rank (pickled; small objects)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` in place with rank ``src``'s values."""
    if _size(None) == 1:
        return
    with torch.no_grad():
        for t in tensors:
            buf = _staged(t, None)
            dist.broadcast(buf, src=src)
            if buf is not t:
                t.copy_(buf)
