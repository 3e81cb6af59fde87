"""Tensor parallelism in one process over a model group of devices (the
'model' mesh axis of the JAX package, `emotivoice_tpu/parallel/sharding.py`).

JAX drives its whole mesh from one process and XLA inserts the collectives.
Here too one process drives a model group: a list of N devices, which may
repeat (N shards on one card) and may be CPU devices. Each parallel layer
holds part i of its split parameters on `devices[i]` and runs part i's work
there; launches are asynchronous, so several cards overlap from one host
thread. Whatever `sharding.py` keeps whole lives on `devices[0]`, and so do
the activations between parallel layers. The collectives are plain
differentiable tensor ops, so autograd gives the exact gradients across
shards (the weight-norm folds below need that):
  - `broadcast`: the whole input to every shard's device;
  - `gather_shards` (`sharding.py`): the shards' outputs concatenated on
    `devices[0]`;
  - `reduce_partials`: the shards' partial sums added on `devices[0]`.

`ColumnParallel` splits a layer's output channels (weight dim 0, bias dim 0;
dim 1 of a transposed conv's weight), `RowParallel` its input channels
(weight dim 1; bias whole, added after the reduction). Both take a
`Linear`, `Conv1dSame` or weight-normalised conv of the port: the layer's
`op()` gives its function of (input, weight, bias). `tensor_parallel`
replaces the layers `sharding.py` splits.

Weight norm W = g v / ||v|| (norm over all dims but 0) across shards:
  - split on dim 0 (column-parallel conv): each output channel's norm lies
    in one shard; g splits with v;
  - split on another dim (row-parallel conv: v on Ci; a transposed conv's
    v (Ci, Co, K) on Co): the norm spans the shards, so it is the root of
    the sum of the shards' partial squares, reduced before the fold. A
    per-shard norm is a different function that runs without error.
    g stays whole on `devices[0]`.

A parallel module's `state_dict()` and `load_state_dict()` use the whole
layout and names (`weight_v`, not its parts `weight_v_0`, `weight_v_1`),
so checkpoints and the converters work unchanged; `optimizer_state_dict`
does the same for Adam's moments.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from emotivoice_tpu_torch.parallel.sharding import (
    gather_shards,
    param_partition_spec,
    shard_tensor,
)

Device = Union[str, torch.device]


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def broadcast(x: Optional[torch.Tensor], devices: Sequence[torch.device]) -> list:
    """`x` on every device (None stays None)."""
    return [None if x is None else x.to(d) for d in devices]


def reduce_partials(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The sum of the shards' partials on `device`, in shard order."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


# ---------------------------------------------------------------------------
# the layers' functions of (input, weight, bias)
# ---------------------------------------------------------------------------

def conv1d_btc(x, w, b, padding, dilation=1):
    """Conv1d over feature-last (B, T, C); `b` may be None."""
    y = F.conv1d(x.transpose(1, 2), w, padding=padding, dilation=dilation).transpose(1, 2)
    return y if b is None else y + b


def conv_transpose1d_btc(x, w, b, stride, padding):
    """ConvTranspose1d over feature-last (B, T, C); `b` may be None."""
    y = F.conv_transpose1d(x.transpose(1, 2), w, stride=stride, padding=padding).transpose(1, 2)
    return y if b is None else y + b


def conv2d(stride, padding) -> Callable:
    return functools.partial(F.conv2d, stride=stride, padding=padding)


def conv1d(padding, dilation=1) -> Callable:
    return functools.partial(conv1d_btc, padding=padding, dilation=dilation)


def conv_transpose1d(stride, padding) -> Callable:
    return functools.partial(conv_transpose1d_btc, stride=stride, padding=padding)


# ---------------------------------------------------------------------------
# parameters over a model group
# ---------------------------------------------------------------------------

class ShardedParameters(nn.Module):
    """Parameters each held whole on `devices[0]` (registered as `name`) or
    split into N equal parts along one dim, part i on `devices[i]` (as
    `name_i`). The state dict holds every parameter whole, under its own
    name, on `devices[0]`."""

    def __init__(self, devices: Sequence[Device],
                 params: Sequence[Tuple[str, torch.Tensor, Optional[int]]]):
        super().__init__()
        self.devices = [torch.device(d) for d in devices]
        self.layout: Dict[str, Optional[int]] = {}
        for name, whole, dim in params:
            self.layout[name] = dim
            whole = whole.detach()
            if dim is None:
                self.register_parameter(name, nn.Parameter(whole.to(self.devices[0], copy=True)))
                continue
            for i, (part, dev) in enumerate(zip(shard_tensor(whole, dim, len(self.devices)),
                                                self.devices)):
                self.register_parameter(f"{name}_{i}", nn.Parameter(part.to(dev)))

    def parts(self, name: str) -> List[torch.Tensor]:
        """The parameter's parts in shard order ([the whole one] if whole)."""
        if self.layout[name] is None:
            return [getattr(self, name)]
        return [getattr(self, f"{name}_{i}") for i in range(len(self.devices))]

    def whole(self, name: str) -> torch.Tensor:
        dim = self.layout[name]
        if dim is None:
            return getattr(self, name)
        return gather_shards(self.parts(name), dim, self.devices[0])

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        for name in self.layout:
            t = self.whole(name)
            destination[prefix + name] = t if keep_vars else t.detach()

    def _load_from_state_dict(self, state_dict, prefix, *args):
        for name, dim in self.layout.items():
            key = prefix + name
            if dim is not None and key in state_dict:
                whole = state_dict.pop(key)
                for i, part in enumerate(shard_tensor(whole, dim, len(self.devices))):
                    state_dict[f"{key}_{i}"] = part
        super()._load_from_state_dict(state_dict, prefix, *args)


def _norm_except_dim0(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())), keepdim=True))


class _ParallelLayer(ShardedParameters):
    """A Linear or conv of the port, weight-normalised or not, with its
    weight split on `dim`. `out_dim` is the weight's output-channel dim
    (0, or 1 for a transposed conv); the bias splits with the output
    channels, else it stays whole. `channel_dim` is the activations'."""

    def __init__(self, mod: nn.Module, devices: Sequence[Device], dim: int):
        out_dim = getattr(mod, "out_dim", 0)
        bias = ("bias", mod.bias, 0 if dim == out_dim else None)
        wn = hasattr(mod, "weight_v")
        if wn:
            params = (("weight_g", mod.weight_g, 0 if dim == 0 else None),
                      ("weight_v", mod.weight_v, dim), bias)
        else:
            params = (("weight", mod.weight, dim), bias)
        super().__init__(devices, params)
        self.wn, self.dim = wn, dim
        self.channel_dim = getattr(mod, "channel_dim", -1)
        self.op = mod.op()

    def weights(self) -> List[torch.Tensor]:
        """Each shard's effective weight (weight norm folded, f32)."""
        if not self.wn:
            return self.parts("weight")
        vs = self.parts("weight_v")
        if self.dim == 0:  # each output channel's norm lies in one shard
            return [g * v / torch.clamp(_norm_except_dim0(v), min=1e-12)
                    for g, v in zip(self.parts("weight_g"), vs)]
        dims = tuple(range(1, vs[0].dim()))
        sq = reduce_partials([torch.sum(v * v, dim=dims, keepdim=True) for v in vs],
                             self.devices[0])
        norm = torch.clamp(torch.sqrt(sq), min=1e-12)
        g = self.weight_g
        return [g.to(v.device) * v / norm.to(v.device) for v in vs]

    def folded(self) -> torch.Tensor:
        """The whole effective weight on `devices[0]`."""
        return gather_shards(self.weights(), self.dim, self.devices[0])

    def folded_hio(self, dtype: torch.dtype) -> torch.Tensor:
        """The whole folded conv weight in HIO (K, Ci, Co), as the kernels take it."""
        return self.folded().permute(2, 1, 0).to(dtype).contiguous()

    def whole_bias(self, dtype: torch.dtype) -> torch.Tensor:
        return self.whole("bias").to(dtype).contiguous()


class ColumnParallel(_ParallelLayer):
    """Output channels split over the group: shard i computes its channels
    from the whole input; `forward` gathers them on `devices[0]`."""

    def __init__(self, mod: nn.Module, devices: Sequence[Device]):
        super().__init__(mod, devices, getattr(mod, "out_dim", 0))

    def forward_shards(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Shard i's output channels from xs[i], the whole input on devices[i]."""
        return [self.op(x, w.to(x.dtype), b.to(x.dtype))
                for x, w, b in zip(xs, self.weights(), self.parts("bias"))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gather_shards(self.forward_shards(broadcast(x, self.devices)),
                               self.channel_dim, self.devices[0])


class RowParallel(_ParallelLayer):
    """Input channels split over the group: shard i's partial sum over its
    channels, reduced on `devices[0]`, then the whole bias."""

    def __init__(self, mod: nn.Module, devices: Sequence[Device]):
        super().__init__(mod, devices, 1 - getattr(mod, "out_dim", 0))

    def forward_partials(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """xs[i]: shard i's input channels on devices[i]."""
        y = reduce_partials([self.op(x, w.to(x.dtype), None)
                             for x, w in zip(xs, self.weights())], self.devices[0])
        return y + self.bias.to(y.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        chunks = x.chunk(len(self.devices), self.channel_dim)
        return self.forward_partials([c.to(d) for c, d in zip(chunks, self.devices)])


# ---------------------------------------------------------------------------
# a model over a model group
# ---------------------------------------------------------------------------

def tensor_parallel(module: nn.Module, devices: Sequence[Device]) -> nn.Module:
    """`module` (a `JETSGenerator` or `Discriminator`, or a tree holding
    them under those names) over the model group `devices`, in place: the
    layers `sharding.param_partition_spec` splits become their parallel
    versions, everything else moves to `devices[0]`. One device is
    `module.to(devices[0])`."""
    devs = [torch.device(d) for d in devices]
    module.to(devs[0])
    if len(devs) > 1:
        _convert(module, "", devs)
    return module


def _convert(parent: nn.Module, prefix: str, devices: List[torch.device]) -> None:
    for name, child in list(parent.named_children()):
        new = _parallel_version(child, prefix + name, devices)
        if new is None:
            _convert(child, prefix + name + ".", devices)
        else:
            setattr(parent, name, new)


def _parallel_version(mod: nn.Module, name: str, devices: List[torch.device]):
    from emotivoice_tpu_torch.models.hifigan import ParallelResBlock1, ResBlock1, WeightNorm
    from emotivoice_tpu_torch.models.transformer import (
        ConvFFN,
        HeadParallelAttention,
        MultiHeadedAttention,
        ParallelConvFFN,
    )

    n = len(devices)

    def spec(leaf: str) -> Optional[int]:
        p = mod.get_parameter(leaf)
        return param_partition_spec(f"{name}.{leaf}", tuple(p.shape), n)

    if isinstance(mod, MultiHeadedAttention):
        if spec("linear_q.weight") == 0 and mod.n_heads % n == 0:
            return HeadParallelAttention(mod, devices)
    elif isinstance(mod, ConvFFN):
        if spec("w_1.weight") == 0 and spec("w_2.weight") == 1:
            return ParallelConvFFN(mod, devices)
    elif isinstance(mod, ResBlock1):
        if spec("convs1.0.weight_v") == 0 and spec("convs2.0.weight_v") == 1:
            return ParallelResBlock1(mod, devices)
    elif isinstance(mod, WeightNorm):
        dim = spec("weight_v")
        if dim is not None:
            cls = ColumnParallel if dim == getattr(mod, "out_dim", 0) else RowParallel
            return cls(mod, devices)
    return None


def full_parameters(module: nn.Module) -> List[Tuple[str, List[torch.Tensor], Optional[int]]]:
    """(name, parts, split dim or None) of every parameter, in the order
    the one-device module's `named_parameters()` gives the whole ones."""
    out = []
    for mname, mod in module.named_modules():
        prefix = mname + "." if mname else ""
        if isinstance(mod, ShardedParameters):
            out += [(prefix + k, mod.parts(k), d) for k, d in mod.layout.items()]
        else:
            out += [(prefix + k, [p], None) for k, p in mod.named_parameters(recurse=False)]
    return out


def _whole_state(ss: List[dict], dim: Optional[int]) -> dict:
    out = {}
    for k, v in ss[0].items():
        split = dim is not None and torch.is_tensor(v) and v.dim() > 0
        out[k] = gather_shards([s[k] for s in ss], dim, v.device) if split else v
    return out


def optimizer_state_dict(opt: torch.optim.Optimizer, module: nn.Module) -> dict:
    """`opt.state_dict()` in the one-device layout of `module`, whose
    parameters `opt` holds in one group: per-parameter state tensors (Adam's
    moments) gathered whole, indices those of the whole parameters."""
    (group,) = opt.param_groups
    index = {id(p): i for i, p in enumerate(group["params"])}
    sd = opt.state_dict()
    entries = full_parameters(module)
    state = {}
    for j, (_, parts, dim) in enumerate(entries):
        ss = [sd["state"].get(index[id(p)]) for p in parts]
        if ss[0] is not None:
            state[j] = _whole_state(ss, dim)
    return {"state": state,
            "param_groups": [{**sd["param_groups"][0], "params": list(range(len(entries)))}]}


def load_optimizer_state_dict(opt: torch.optim.Optimizer, module: nn.Module, state: dict) -> None:
    """The inverse of `optimizer_state_dict`: a one-device layout state
    loaded into `opt` over `module`'s (possibly split) parameters."""
    (group,) = opt.param_groups
    index = {id(p): i for i, p in enumerate(group["params"])}
    local = {}
    for j, (_, parts, dim) in enumerate(full_parameters(module)):
        s = state["state"].get(j)
        if s is None:
            continue
        split = {k: shard_tensor(v, dim, len(parts)) for k, v in s.items()
                 if dim is not None and torch.is_tensor(v) and v.dim() > 0}
        for i, p in enumerate(parts):
            local[index[id(p)]] = {k: split[k][i] if k in split else v for k, v in s.items()}
    opt.load_state_dict({"state": local, "param_groups": [
        {**state["param_groups"][0], "params": list(range(len(group["params"])))}]})
