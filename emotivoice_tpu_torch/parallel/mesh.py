"""Devices and ranks into model groups (counterpart of
`emotivoice_tpu/parallel/mesh.py`).

The JAX package lays whatever devices it is given, those of every process
under `jax.distributed`, out as a ('data', 'model') mesh: the list reshaped
to (n / N, N). The port has two forms of it:

  - one process, a list of devices: `make_mesh` cuts it into model groups
    of `model_parallel_size` devices each (the 'model' axis,
    `tensor_parallel.LocalGroup`), and the groups are the data axis of that
    process: the engine holds one replica per group and `split_rows` gives
    each its rows;
  - W processes, one device each: `make_rank_mesh` lays the ranks of the
    default process group out as (W / N, N) the same way. Ranks r with the
    same r // N form one model group (`tensor_parallel.RankGroup`: one
    shard per rank), ranks with the same r % N one data group
    (`data_parallel.DataParallel`: the gradient mean over it). With N = 1
    every rank is its own model group and the data group is the world,
    the data-parallel runs of `data_parallel.py`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist


def make_mesh(devices: Sequence[Union[str, torch.device]],
              model_parallel_size: int = 1) -> List[List[torch.device]]:
    """`len(devices) // model_parallel_size` model groups of consecutive
    devices. Devices may repeat (several shards on one card) and may be CPU
    devices."""
    devs = [torch.device(d) for d in devices]
    if not devs or model_parallel_size < 1 or len(devs) % model_parallel_size:
        raise ValueError(f"{len(devs)} devices do not split into model groups of "
                         f"{model_parallel_size}")
    n = model_parallel_size
    return [devs[i:i + n] for i in range(0, len(devs), n)]


def split_rows(n_rows: int, n_groups: int) -> List[slice]:
    """Group i's rows of a batch of `n_rows`: [i n/g, (i+1) n/g)."""
    if n_rows % n_groups:
        raise ValueError(f"a bucket of {n_rows} rows does not split over {n_groups} replicas")
    k = n_rows // n_groups
    return [slice(i * k, (i + 1) * k) for i in range(n_groups)]


def rank_layout(world_size: int, model_parallel_size: int) -> np.ndarray:
    """The (data, model) array of ranks, (W / N, N): row i is model group i,
    column j data group j (JAX's `np.asarray(devices).reshape(n // N, N)`)."""
    n = model_parallel_size
    if world_size < 1 or n < 1 or world_size % n:
        raise ValueError(f"{world_size} ranks do not split into model groups of {n}")
    return np.arange(world_size).reshape(world_size // n, n)


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """This rank's place in the (data, model) layout of the ranks: its
    data index (its model group's row), its model index (its shard), the
    axis sizes, and the two `torch.distributed` groups it belongs to (None
    in a run of one process)."""

    data_index: int
    model_index: int
    n_data: int
    n_model: int
    data_group: Optional[dist.ProcessGroup]
    model_group: Optional[dist.ProcessGroup]


def make_rank_mesh(model_parallel_size: int = 1) -> RankMesh:
    """The default process group's ranks as a (data, model) mesh with
    model groups of `model_parallel_size` (`rank_layout`). Every rank must
    call it, in the same order relative to its other collectives: each
    rank creates every group (`dist.new_group` is collective over the
    world, so a rank that created only its own would hang) and keeps the
    two it belongs to. One process without a process group is a mesh of
    one rank."""
    if not (dist.is_available() and dist.is_initialized()):
        rank_layout(1, model_parallel_size)
        return RankMesh(0, 0, 1, 1, None, None)
    world, rank = dist.get_world_size(), dist.get_rank()
    layout = rank_layout(world, model_parallel_size)
    model_group = data_group = None
    for row in layout:
        g = dist.new_group(row.tolist())
        if rank in row:
            model_group = g
    for col in layout.T:
        g = dist.new_group(col.tolist())
        if rank in col:
            data_group = g
    d, m = divmod(rank, model_parallel_size)
    return RankMesh(d, m, layout.shape[0], layout.shape[1], data_group, model_group)
