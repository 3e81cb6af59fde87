"""Several processes, one per device: the process group and each rank's
share of the data (counterpart of `emotivoice_tpu/parallel/multihost.py`).

The JAX package joins hosts with `jax.distributed.initialize` and lets XLA
place every collective. Here each process drives one device and joins a
`torch.distributed` process group; the launcher is torchrun or anything
that sets its environment:

  RANK, WORLD_SIZE   this process's rank and the number of processes
  LOCAL_RANK         its rank on this host (which card it drives)
  MASTER_ADDR, MASTER_PORT   the rendezvous address of rank 0

The backend is chosen once and never switched on failure: NCCL for CUDA
devices, gloo for the CPU, unless the caller names one. Two ranks that share
one card need gloo (NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist


def local_rank() -> int:
    """LOCAL_RANK from the environment (0 when unset)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def initialize_multihost(
    device: Union[str, torch.device] = "cpu",
    backend: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    master_addr: Optional[str] = None,
    master_port: Optional[int] = None,
    timeout_s: float = 1800.0,
) -> Tuple[int, int]:
    """Join the process group (idempotent; a no-op for one process) and
    return (rank, world_size).

    Arguments left None come from the torchrun environment. `backend`
    defaults to NCCL for a CUDA `device` and gloo otherwise."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    if world_size <= 1:
        return 0, 1
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is outside a world of {world_size}")
    addr = master_addr or os.environ.get("MASTER_ADDR")
    port = master_port or os.environ.get("MASTER_PORT")
    if not addr or not port:
        raise RuntimeError("a multi-process run needs MASTER_ADDR and MASTER_PORT "
                           "(or master_addr / master_port)")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{addr}:{port}",
        rank=rank, world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s))
    return rank, world_size


def shard_datalist(items: Sequence, rank: int, world_size: int) -> list:
    """This rank's disjoint share of a datalist: rows rank, rank + world, ..."""
    return list(items)[rank::world_size]
