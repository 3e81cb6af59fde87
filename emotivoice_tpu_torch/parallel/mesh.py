"""Devices into model groups (counterpart of `emotivoice_tpu/parallel/mesh.py`).

The JAX package lays its devices out as a ('data', 'model') mesh. Here one
process drives a list of devices: `make_mesh` cuts it into model groups of
`model_parallel_size` devices each (the 'model' axis, `tensor_parallel.py`),
and the groups are the data axis of one process: the engine holds one
replica per group and `split_rows` gives each its rows. Ranks of a process
group (`data_parallel.py`) add a data axis across processes.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import torch


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
