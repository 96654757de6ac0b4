"""The process group of a data-parallel run (counterpart of
tf_vqa_regat_tpu/parallel/distributed.py), with the JAX package's
environment contract:

    REGAT_COORDINATOR=host:port  REGAT_NUM_PROCESSES=N  REGAT_PROCESS_ID=i

opens `init_process_group(init_method="tcp://host:port")` for N > 1, and
`REGAT_AUTO_DISTRIBUTED=1` opens it from torchrun's variables (`env://`:
RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), JAX's bare auto-discovery.
The backend is NCCL for a CUDA device and gloo for the CPU; it never
changes on its own. A group opened by the caller before the entry point
runs is used as it is (gloo's CUDA collectives stage through the host, so
two ranks may share one card that way; NCCL refuses that).

Each rank runs on `rank_device`: the CPU when asked, else
cuda:(LOCAL_RANK % device count). The collectives here flatten a list of
tensors into one buffer per call: `all_reduce_` (sum or max) and
`broadcast_` (from rank 0, or from a group's first rank), and `all_gather`
concatenates the ranks' tensors along an axis. Each takes a `group`: None
is the world; `mesh_groups` gives a dp x tp mesh its data groups (the ranks
with the same model index) and model groups (the ranks with the same data
index). Only all-reduce, all-gather and broadcast are used: NCCL and gloo
both take them on CUDA tensors. Every helper is a no-op without a group,
and on a group of one rank. JAX's `put_global` has no counterpart: each
rank places its own tensors on its own device.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def is_primary() -> bool:
    """True on the rank that writes the shared files (logs, metrics,
    checkpoints, the final parameters, predictions): rank 0."""
    return rank() == 0


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", rank()))


def _local_world() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))


def cuda_index(local_rank: int, local_world: int, device_count: int, backend: str) -> int:
    """The card of a rank: local_rank % device_count. Under NCCL two ranks of
    one host may not share a card (NCCL refuses a duplicate device), so more
    local ranks than cards raise here, before any collective; gloo stages
    its CUDA collectives through the host and may share one."""
    if device_count < 1:
        raise RuntimeError("no CUDA device is visible to this rank")
    if backend == "nccl" and local_world > device_count:
        raise ValueError(
            f"{local_world} ranks on this host map to {device_count} CUDA device(s): NCCL "
            f"cannot run two ranks on one card. Start at most one rank per card, or open "
            f"a gloo process group yourself before the entry point runs (its CUDA "
            f"collectives stage through the host)"
        )
    return local_rank % device_count


def maybe_initialize(device_type: str = "cuda") -> bool:
    """Open the process group from the environment (module docstring); True
    if this call opened it. A group that is already open is left as it is."""
    if initialized():
        return False
    backend = backend_for(device_type)
    if os.environ.get("REGAT_AUTO_DISTRIBUTED") == "1":
        if backend == "nccl":
            cuda_index(int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0"))),
                       int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1"))),
                       torch.cuda.device_count(), backend)
        dist.init_process_group(backend, init_method="env://")
        return True
    coord = os.environ.get("REGAT_COORDINATOR")
    n = int(os.environ.get("REGAT_NUM_PROCESSES", "1"))
    if coord and n > 1:
        pid = int(os.environ["REGAT_PROCESS_ID"])
        if backend == "nccl":
            cuda_index(int(os.environ.get("LOCAL_RANK", pid)),
                       int(os.environ.get("LOCAL_WORLD_SIZE", n)), torch.cuda.device_count(),
                       backend)
        dist.init_process_group(backend, init_method=f"tcp://{coord}", world_size=n, rank=pid)
        return True
    return False


def rank_device(name: str) -> torch.device:
    """This rank's device for `--device name`: the CPU as asked, an explicit
    cuda:N as given, and `cuda` -> cuda:(LOCAL_RANK % device count) under a
    group (cuda_index), which becomes the current device."""
    device = torch.device(name)
    if device.type != "cuda" or not initialized():
        return device
    if device.index is None:
        device = torch.device("cuda", cuda_index(
            _local_rank(), _local_world(), torch.cuda.device_count(), dist.get_backend()))
    torch.cuda.set_device(device)
    return device


def destroy() -> None:
    if initialized():
        _MESH_GROUPS.clear()
        dist.destroy_process_group()


# (the world group the groups were made under, dp, tp) -> (data, model)
_MESH_GROUPS: dict = {}


def mesh_groups(dp: int, tp: int) -> Tuple[Any, Any]:
    """(this rank's data group, its model group) of a dp x tp mesh over the
    world, rank r at (r // tp, r % tp): the data group holds the ranks of
    r's model index, the model group those of r's data index. At tp = 1 the
    data group is the world and the model group None (one rank). Every rank
    creates every group once, in the same order (new_group's contract), on
    its first call for (dp, tp) under the open world group."""
    if tp == 1:
        return None, None
    key = (dp, tp)
    cached = _MESH_GROUPS.get(key)
    if cached is not None and cached[0] is dist.group.WORLD:
        return cached[1]
    r = rank()
    data = model = None
    for m in range(tp):  # data groups: one per model index
        g = dist.new_group([d * tp + m for d in range(dp)])
        if r % tp == m:
            data = g
    for d in range(dp):  # model groups: one per data index
        g = dist.new_group([d * tp + m for m in range(tp)])
        if r // tp == d:
            model = g
    _MESH_GROUPS[key] = (dist.group.WORLD, (data, model))
    return data, model


def group_size(group: Optional[Any] = None) -> int:
    """Ranks in `group` (None: the world); 1 without a process group."""
    if not initialized():
        return 1
    return dist.get_world_size(group) if group is not None else dist.get_world_size()


def barrier() -> None:
    if world_size() > 1:
        if dist.get_backend() == "nccl":  # on this rank's card
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def _flat_groups(tensors: Sequence[torch.Tensor]) -> List[List[int]]:
    """Indices of `tensors` grouped by (dtype, device), in order."""
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    return list(groups.values())


def all_reduce_(tensors: Sequence[torch.Tensor], op: str = "sum",
                group: Optional[Any] = None) -> None:
    """Reduce `tensors` over `group` (None: the world) in place (sum or
    max), one flat buffer per dtype; a lone contiguous tensor is reduced as
    it is."""
    if not initialized() or (group is not None and group_size(group) == 1):
        return
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    for idx in _flat_groups(tensors):
        ts = [tensors[i] for i in idx]
        if len(ts) == 1 and ts[0].is_contiguous():
            dist.all_reduce(ts[0], op=red, group=group)
            continue
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, op=red, group=group)
        _unflatten_into(flat, ts)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0,
               group: Optional[Any] = None) -> None:
    """Overwrite `tensors` with those of global rank `src` (a member of
    `group`, None: the world), in place, one flat buffer per dtype."""
    if group_size(group) <= 1:
        return
    for idx in _flat_groups(tensors):
        ts = [tensors[i] for i in idx]
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.broadcast(flat, src=src, group=group)
        _unflatten_into(flat, ts)


def all_gather(t: torch.Tensor, dim: int, group: Optional[Any] = None) -> torch.Tensor:
    """The ranks' `t` of `group` (None: the world), each of the same shape,
    concatenated along `dim` in rank order (a new tensor; `t` itself
    without a group of more than one rank)."""
    n = group_size(group)
    if n <= 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


@torch.no_grad()
def _unflatten_into(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off : off + n].view_as(t))
        off += n


def any_rank(flag: bool) -> bool:
    """True when `flag` is True on any rank (a MAX all-reduce, on this rank's
    card under NCCL; the flag itself without a group of more than one
    rank)."""
    if world_size() <= 1:
        return flag
    device = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(int(t.item()))
