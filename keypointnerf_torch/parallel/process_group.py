"""Process groups: one process a device, joined by torch.distributed.

Counterpart of `keypointnerf_tpu/parallel/mesh.py`. The reference trains
with Lightning DDP (reference train.py:71), the JAX package with one mesh
over its devices; the port uses PyTorch's idiom: one process per device,
each with its rank, in a `torch.distributed` group that the caller starts
with an explicit backend, NCCL for CUDA devices and gloo for the CPU (gloo
also takes CUDA tensors for all-reduce, broadcast and barrier, which is
all the port issues, so two ranks may share one card over gloo; NCCL
refuses two ranks on one device). The backend is printed; nothing picks
another one when it fails.

Every collective of the port goes through the wrappers below, which add
a record to `audit.AUDIT`.
"""
from __future__ import annotations

import datetime
import socket
from typing import Optional

import torch
import torch.distributed as dist

from .audit import AUDIT

BACKENDS = ("nccl", "gloo")


def free_port() -> int:
    """A free TCP port on localhost, for a coordinator started here."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device=None) -> bool:
    """Join the `num_processes`-process group at `tcp://coordinator`
    (host:port) as rank `process_id`, over `backend` (default: NCCL for a
    CUDA `device`, gloo otherwise). A no-op returning False for one
    process; True once joined."""
    if num_processes is None or num_processes <= 1:
        return False
    if coordinator is None:
        raise ValueError(f"{num_processes} processes need a coordinator address (host:port)")
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"process_id must be in [0, {num_processes}), got {process_id}")
    dev = torch.device("cpu" if device is None else device)
    backend = backend or default_backend(dev)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    kw = {}
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"the nccl backend needs a CUDA device, got {dev}")
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(minutes=10), **kw)
    print(f"rank {process_id} of {num_processes}: torch.distributed backend {backend} on "
          f"{dev} (coordinator {coordinator})", flush=True)
    return True


def destroy() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def default_group():
    """The default group (`torch.distributed.group.WORLD`) once one is
    initialized, else None (no group)."""
    return dist.group.WORLD if _initialized() else None


def rank(group=None) -> int:
    """This process's rank in `group` (the default group when None); 0
    without a group."""
    return dist.get_rank(group) if _initialized() else 0


def world_size(group=None) -> int:
    """The number of ranks in `group`; 1 without a group."""
    return dist.get_world_size(group) if _initialized() else 1


def rank_device(rank_: int, device_type: str = "cuda"):
    """The device of rank `rank_` on its host: `cuda:<rank mod cards>` for
    CUDA (ranks numbered host by host; more ranks than cards share them,
    which gloo takes and NCCL refuses), the CPU otherwise."""
    if device_type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", rank_ % max(torch.cuda.device_count(), 1))


def all_reduce_(t: torch.Tensor, kind: str, group=None) -> torch.Tensor:
    """In-place sum of `t` over the ranks of `group`, recorded as `kind`."""
    AUDIT.record(kind, "all_reduce", t.numel() * t.element_size())
    dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, kind: str, src: int = 0, group=None) -> torch.Tensor:
    """In-place broadcast of rank `src`'s `t`, recorded as `kind`."""
    AUDIT.record(kind, "broadcast", t.numel() * t.element_size())
    dist.broadcast(t, src=src, group=group)
    return t


def barrier(kind: str = "barrier", group=None) -> None:
    """Wait for every rank of `group`; a no-op without a group."""
    if world_size(group) > 1:
        AUDIT.record(kind, "barrier", 0)
        dist.barrier(group=group)
