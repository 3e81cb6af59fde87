"""Tensor-parallel parameter layout over a model group (counterpart of
`emotivoice_tpu/parallel/sharding.py`).

Megatron-style column/row-parallel splits of the HiFi-GAN channel dimension,
the transformer's attention heads and FFN, and the MPD towers, stated on the
port's own parameter names (the reference checkpoint's: `generator.ups.0.
weight_v`, `am.encoder.encoders.0.self_attn.linear_q.weight`, `mpd.
discriminators.0.convs.1.weight_g`, ...) and PyTorch layouts. Names are
those of a `JETSGenerator` (`am.*`, `generator.*`) or a `Discriminator`
(`mpd.*`, `msd.*`) state dict. `param_partition_spec` gives the dimension a
parameter is split on, or None where it is held whole; `tensor_parallel.py`
builds the layers that follow it.

Layout rules (N = the model group's size; a split is applied only when the
dimension divides by N, as the JAX package's `_div` guard does, so a 3-way
group leaves the power-of-two channel counts whole):

HiFi-GAN generator (weight norm: g, v, bias; conv v (Co, Ci, K), transposed
conv v (Ci, Co, K)):
  - conv_pre            column-parallel: v dim 0, g dim 0, bias dim 0
  - ups.i (tconv)       column-parallel on the output: v dim 1, bias dim 0;
                        g is per *input* channel and stays whole (the JAX
                        table splits it on dim 0; every shard's fold needs
                        all of it, and it is Ci floats)
  - resblocks convs1.j  column-parallel (v dim 0, g dim 0, bias dim 0)
  - resblocks convs2.j  row-parallel (v dim 1 = Ci); g, bias whole
  - conv_post           row-parallel (v dim 1 = Ci); 1 output channel
  - ResBlock2 convs     whole

Acoustic-model transformer (Linear weight (out, in), Conv1d (Co, Ci, K);
the JAX kernels are (in, out) and (K, Ci, Co)):
  - self_attn linear_q/k/v   weight dim 0 (head-parallel), bias dim 0
  - self_attn linear_out     weight dim 1 (row-parallel), bias whole
  - feed_forward w_1         weight dim 0, bias dim 0
  - feed_forward w_2         weight dim 1 (row-parallel), bias whole
  An attention layer is split only when its head count divides by N too
  (each shard runs whole heads); JAX lets XLA split inside a head.

MPD discriminator towers: column-parallel on every convs.j (v, g, bias dim
0); conv_post whole. The MSD stacks use grouped convs (up to 16 groups)
whose channel/group interaction does not split cleanly on one axis: whole.

Everything else (embeddings, layer norms, the variance adaptor, the
aligner, spectral-norm state) is whole. Adam's moments mirror the
parameters.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import torch


def _div(shape: Sequence[int], dim: int, size: int) -> bool:
    return 0 <= dim < len(shape) and shape[dim] % size == 0 and shape[dim] >= size


def _rule(name: str) -> Optional[int]:
    """The dim the layout rules split `name` on, before the divisibility guard."""
    parts = name.split(".")
    leaf, owner = parts[-1], parts[:-1]
    if not owner:
        return None
    layer = owner[-2] if owner[-1].isdigit() and len(owner) > 1 else owner[-1]

    def column() -> Optional[int]:
        return {"weight_v": 0, "weight_g": 0, "bias": 0}.get(leaf)

    def row() -> Optional[int]:
        return 1 if leaf in ("weight_v", "weight") else None

    if "generator" in parts:
        if layer in ("conv_pre", "convs1"):
            return column()
        if layer == "ups":
            return {"weight_v": 1, "bias": 0}.get(leaf)
        if layer in ("convs2", "conv_post"):
            return row()
        return None
    if "mpd" in parts:
        return column() if layer == "convs" else None
    if "self_attn" in parts:
        if layer in ("linear_q", "linear_k", "linear_v"):
            return {"weight": 0, "bias": 0}.get(leaf)
        return row() if layer == "linear_out" else None
    if "feed_forward" in parts:
        if layer == "w_1":
            return {"weight": 0, "bias": 0}.get(leaf)
        return row() if layer == "w_2" else None
    return None


def param_partition_spec(name: str, shape: Sequence[int], size: int) -> Optional[int]:
    """The dim parameter `name` of `shape` is split on over a model group of
    `size`, or None where it is held whole."""
    if size <= 1 or len(shape) == 0:
        return None
    dim = _rule(name)
    return dim if dim is not None and _div(shape, dim, size) else None


def partition_dims(state: Mapping[str, torch.Tensor], size: int) -> Dict[str, Optional[int]]:
    """`param_partition_spec` of every entry of a state dict."""
    return {k: param_partition_spec(k, tuple(v.shape), size) for k, v in state.items()}


def shard_tensor(t: torch.Tensor, dim: int, size: int) -> List[torch.Tensor]:
    """`size` equal contiguous parts of `t` along `dim` (copies)."""
    if t.shape[dim] % size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split into {size}")
    return [p.clone(memory_format=torch.contiguous_format) for p in t.chunk(size, dim)]


def gather_shards(parts: Sequence[torch.Tensor], dim: int,
                  device: Optional[torch.device] = None) -> torch.Tensor:
    """The whole tensor from its parts, on `device` (default: the first part's)."""
    device = parts[0].device if device is None else device
    return torch.cat([p.to(device) for p in parts], dim)


def shard_state_dict(state: Mapping[str, torch.Tensor], size: int) -> List[Dict[str, torch.Tensor]]:
    """Shard i's state dict of each of `size` shards: the split entries'
    part i, the whole entries themselves."""
    dims = partition_dims(state, size)
    out: List[Dict[str, torch.Tensor]] = [{} for _ in range(size)]
    for k, v in state.items():
        parts = [v] * size if dims[k] is None else shard_tensor(v, dims[k], size)
        for shard, part in zip(out, parts):
            shard[k] = part
    return out


def gather_state_dict(shards: Sequence[Mapping[str, torch.Tensor]],
                      dims: Mapping[str, Optional[int]]) -> Dict[str, torch.Tensor]:
    """The inverse of `shard_state_dict`, given the `partition_dims` of the
    whole state."""
    return {k: shards[0][k] if dims[k] is None else gather_shards([s[k] for s in shards], dims[k])
            for k in shards[0]}


def count_partitioned(state: Mapping[str, torch.Tensor], size: int) -> int:
    """Elements of the parameters that are split (for tests and logs)."""
    dims = partition_dims(state, size)
    return sum(v.numel() for k, v in state.items() if dims[k] is not None)
