"""Tensor parallelism over a model group (the 'model' mesh axis of the JAX
package, `emotivoice_tpu/parallel/sharding.py`).

A model group holds a model's N shards. It comes in two kinds behind one
interface (`ModelGroup`), so each parallel layer has one code path:

  - `LocalGroup(devices)`: all N shards in this process, shard i on
    `devices[i]` (which may repeat, N shards on one card, and may be CPU
    devices), as JAX drives its whole mesh from one process. Launches are
    asynchronous, so several cards overlap from one host thread. Whatever
    `sharding.py` keeps whole lives on `devices[0]`, and so do the
    activations between parallel layers. The collectives are plain
    differentiable tensor ops (`.to()` copies, `cat`, adds) there.
  - `RankGroup(process_group, device)`: one shard per rank of a
    `torch.distributed` group, one process per device (the form tensor
    parallelism takes in PyTorch; `mesh.make_rank_mesh` lays a world out as
    (data, model) ranks). Whole parameters and the activations between
    parallel layers are replicated on every rank of the group, and every
    rank runs the same calls in the same order, as JAX's multi-controller
    runtime runs one program on every process. The collectives are
    `torch.autograd.Function`s over the group, each with its conjugate
    backward, built from `all_reduce`, `all_gather` and `broadcast` only
    (gloo takes CUDA tensors for those three; NCCL needs a card per rank).

The collectives a parallel layer calls:
  - `enter(x)`: the whole input into the split region, once per shard held
    here. Rank: identity forward, all-reduce (sum) backward, since each
    rank's shard contributes its part of the input's gradient.
  - `scatter(x, dim)`: each held shard's slice of the whole input. Rank:
    this rank's slice forward, all-gather backward.
  - `gather(parts, dim)`: the whole tensor from the shards' slices (exit
    by gather). Rank: all-gather forward, this rank's slice backward.
  - `reduce(parts)`: the sum of the shards' partials (exit by partial
    sums). Rank: all-reduce forward, identity backward: downstream every
    rank holds the same activations and the same gradient, which is each
    partial's gradient. (`torch.distributed.nn.functional.all_reduce`
    all-reduces in its backward too, which multiplies every gradient
    before the split by N and still runs.)

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
    the sum of the shards' partial squares, `enter(reduce(...))`: the sum
    forward and, over ranks, the sum of the ranks' gradients backward
    (each rank folds its own shard with it). A per-shard norm is a
    different function that runs without error. g stays whole and enters
    the split region the same way: its gradient on one rank is a partial,
    summed over the group.

A parallel module's `state_dict()` and `load_state_dict()` use the whole
layout and names (`weight_v`, not its parts `weight_v_0`, `weight_v_1`),
so checkpoints and the converters work unchanged; `optimizer_state_dict`
does the same for Adam's moments. Over ranks, saving gathers over the
group (every rank of it must call it) and loading cuts out the rank's
shard.
"""

from __future__ import annotations

import collections
import functools
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from emotivoice_tpu_torch.parallel.sharding import (
    gather_shards,
    param_partition_spec,
    shard_tensor,
)

Device = Union[str, torch.device]


# ---------------------------------------------------------------------------
# model groups and their collectives
# ---------------------------------------------------------------------------

class ModelGroup:
    """A model group's shards as this process sees them: `size` shards in
    all, of which it holds `shards` (indices), shard `shards[i]` on
    `devices[i]`; whole parameters and the activations between parallel
    layers on `home`. The collectives are described in the module's
    docstring."""

    size: int
    shards: List[int]
    devices: List[torch.device]
    home: torch.device

    def enter(self, x: Optional[torch.Tensor]) -> List[Optional[torch.Tensor]]:
        raise NotImplementedError

    def scatter(self, x: torch.Tensor, dim: int) -> List[torch.Tensor]:
        raise NotImplementedError

    def gather(self, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        raise NotImplementedError

    def reduce(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError


class LocalGroup(ModelGroup):
    """Every shard in this process, shard i on `devices[i]`."""

    def __init__(self, devices: Sequence[Device]):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a model group needs at least one device")
        self.size = len(self.devices)
        self.shards = list(range(self.size))
        self.home = self.devices[0]

    def enter(self, x):
        return [None if x is None else x.to(d) for d in self.devices]

    def scatter(self, x, dim):
        return [c.to(d) for c, d in zip(x.chunk(self.size, dim), self.devices)]

    def gather(self, parts, dim):
        return gather_shards(parts, dim, self.home)

    def reduce(self, parts):
        out = parts[0].to(self.home)
        for p in parts[1:]:
            out = out + p.to(self.home)
        return out


class RankGroup(ModelGroup):
    """One shard per rank of `process_group`: this rank holds shard
    `index` (its rank in the group) on `device`, which is also its home.
    `calls` and `bytes` count the collectives it ran, forward and backward,
    by kind (bytes: the payload of each, the whole gathered tensor for an
    all-gather)."""

    def __init__(self, process_group, device: Device):
        if process_group is None:
            raise ValueError("a rank group needs its process group (mesh.make_rank_mesh)")
        self.group = process_group
        self.size = dist.get_world_size(process_group)
        self.index = dist.get_rank(process_group)
        self.home = torch.device(device)
        self.shards, self.devices = [self.index], [self.home]
        self.first = dist.get_global_rank(process_group, 0)
        self.calls: collections.Counter = collections.Counter()
        self.bytes: collections.Counter = collections.Counter()

    def _count(self, kind: str, t: torch.Tensor, factor: int = 1) -> None:
        self.calls[kind] += 1
        self.bytes[kind] += t.numel() * t.element_size() * factor

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the group, in place; returns `t`."""
        self._count("all_reduce", t)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' `t` concatenated along `dim`, in rank order."""
        t = t.contiguous()
        self._count("all_gather", t, self.size)
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """The group's first rank's `t` on every rank, in place; returns `t`."""
        self._count("broadcast", t)
        dist.broadcast(t, src=self.first, group=self.group)
        return t

    def enter(self, x):
        return [None if x is None else _Enter.apply(x, self)]

    def scatter(self, x, dim):
        return [_Scatter.apply(x, dim, self)]

    def gather(self, parts, dim):
        (part,) = parts
        return _Gather.apply(part, dim, self)

    def reduce(self, parts):
        (part,) = parts
        return _Reduce.apply(part, self)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce(grad.clone(memory_format=torch.contiguous_format)), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        g = ctx.group
        return grad.chunk(g.size, ctx.dim)[g.index].contiguous(), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return x.chunk(group.size, dim)[group.index].clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_gather(grad, ctx.dim), None, None


def as_group(group: Union[ModelGroup, Sequence[Device]]) -> ModelGroup:
    """A `ModelGroup` as it is, a list of devices as a `LocalGroup`."""
    return group if isinstance(group, ModelGroup) else LocalGroup(group)


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
    """Parameters over a model group (a `ModelGroup` or a list of devices),
    each held whole on the group's home (registered as `name`) or split
    into N equal parts along one dim, the held parts on their devices (as
    `name_i`). The state dict holds every parameter whole, under its own
    name, on the home device."""

    def __init__(self, group: Union[ModelGroup, Sequence[Device]],
                 params: Sequence[Tuple[str, torch.Tensor, Optional[int]]]):
        super().__init__()
        self.group = as_group(group)
        self.layout: Dict[str, Optional[int]] = {}
        for name, whole, dim in params:
            self.layout[name] = dim
            whole = whole.detach()
            if dim is None:
                self.register_parameter(name, nn.Parameter(whole.to(self.group.home, copy=True)))
                continue
            parts = shard_tensor(whole, dim, self.group.size)
            for i, dev in zip(self.group.shards, self.group.devices):
                self.register_parameter(f"{name}_{i}", nn.Parameter(parts[i].to(dev)))

    def parts(self, name: str) -> List[torch.Tensor]:
        """The held parts of a parameter in shard order ([the whole one] if whole)."""
        if self.layout[name] is None:
            return [getattr(self, name)]
        return [getattr(self, f"{name}_{i}") for i in self.group.shards]

    def whole(self, name: str) -> torch.Tensor:
        dim = self.layout[name]
        if dim is None:
            return getattr(self, name)
        return self.group.gather(self.parts(name), dim)

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        for name in self.layout:
            t = self.whole(name)
            destination[prefix + name] = t if keep_vars else t.detach()

    def _load_from_state_dict(self, state_dict, prefix, *args):
        for name, dim in self.layout.items():
            key = prefix + name
            if dim is not None and key in state_dict:
                parts = shard_tensor(state_dict.pop(key), dim, self.group.size)
                for i in self.group.shards:
                    state_dict[f"{key}_{i}"] = parts[i]
        super()._load_from_state_dict(state_dict, prefix, *args)


def _norm_except_dim0(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())), keepdim=True))


class _ParallelLayer(ShardedParameters):
    """A Linear or conv of the port, weight-normalised or not, with its
    weight split on `dim`. `out_dim` is the weight's output-channel dim
    (0, or 1 for a transposed conv); the bias splits with the output
    channels, else it stays whole. `channel_dim` is the activations'."""

    def __init__(self, mod: nn.Module, group, dim: int):
        out_dim = getattr(mod, "out_dim", 0)
        bias = ("bias", mod.bias, 0 if dim == out_dim else None)
        wn = hasattr(mod, "weight_v")
        if wn:
            params = (("weight_g", mod.weight_g, 0 if dim == 0 else None),
                      ("weight_v", mod.weight_v, dim), bias)
        else:
            params = (("weight", mod.weight, dim), bias)
        super().__init__(group, params)
        self.wn, self.dim = wn, dim
        self.channel_dim = getattr(mod, "channel_dim", -1)
        self.op = mod.op()

    def weights(self) -> List[torch.Tensor]:
        """Each held shard's effective weight (weight norm folded, f32)."""
        if not self.wn:
            return self.parts("weight")
        vs = self.parts("weight_v")
        if self.dim == 0:  # each output channel's norm lies in one shard
            return [g * v / torch.clamp(_norm_except_dim0(v), min=1e-12)
                    for g, v in zip(self.parts("weight_g"), vs)]
        dims = tuple(range(1, vs[0].dim()))
        sq = self.group.reduce([torch.sum(v * v, dim=dims, keepdim=True) for v in vs])
        norms = self.group.enter(torch.clamp(torch.sqrt(sq), min=1e-12))
        gains = self.group.enter(self.weight_g)
        return [g * v / n for g, v, n in zip(gains, vs, norms)]

    def folded(self) -> torch.Tensor:
        """The whole effective weight on the home device."""
        return self.group.gather(self.weights(), self.dim)

    def folded_hio(self, dtype: torch.dtype) -> torch.Tensor:
        """The whole folded conv weight in HIO (K, Ci, Co), as the kernels take it."""
        return self.folded().permute(2, 1, 0).to(dtype).contiguous()

    def whole_bias(self, dtype: torch.dtype) -> torch.Tensor:
        return self.whole("bias").to(dtype).contiguous()


class ColumnParallel(_ParallelLayer):
    """Output channels split over the group: each shard computes its
    channels from the whole input; `forward` gathers them."""

    def __init__(self, mod: nn.Module, group):
        super().__init__(mod, group, getattr(mod, "out_dim", 0))

    def forward_shards(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each held shard's output channels from xs[i], the whole input
        entered on its device (`group.enter`)."""
        return [self.op(x, w.to(x.dtype), b.to(x.dtype))
                for x, w, b in zip(xs, self.weights(), self.parts("bias"))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.group.gather(self.forward_shards(self.group.enter(x)), self.channel_dim)


class RowParallel(_ParallelLayer):
    """Input channels split over the group: each shard's partial sum over
    its channels, reduced, then the whole bias."""

    def __init__(self, mod: nn.Module, group):
        super().__init__(mod, group, 1 - getattr(mod, "out_dim", 0))

    def forward_partials(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """xs[i]: held shard i's input channels on its device."""
        y = self.group.reduce([self.op(x, w.to(x.dtype), None)
                               for x, w in zip(xs, self.weights())])
        return y + self.bias.to(y.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_partials(self.group.scatter(x, self.channel_dim))


# ---------------------------------------------------------------------------
# a model over a model group
# ---------------------------------------------------------------------------

def tensor_parallel(module: nn.Module, group: Union[ModelGroup, Sequence[Device]]) -> nn.Module:
    """`module` (a `JETSGenerator` or `Discriminator`, or a tree holding
    them under those names) over the model group `group` (a `ModelGroup`,
    or a list of devices for a `LocalGroup`), in place: the layers
    `sharding.param_partition_spec` splits become their parallel versions,
    everything else moves to the group's home device. A group of one is
    `module.to(home)`. Over a `RankGroup` every rank of the group converts
    the same module (the same parameters) and keeps its own shard."""
    group = as_group(group)
    module.to(group.home)
    if group.size > 1:
        _convert(module, "", group)
    return module


def _convert(parent: nn.Module, prefix: str, group: ModelGroup) -> None:
    for name, child in list(parent.named_children()):
        new = _parallel_version(child, prefix + name, group)
        if new is None:
            _convert(child, prefix + name + ".", group)
        else:
            setattr(parent, name, new)


def _parallel_version(mod: nn.Module, name: str, group: ModelGroup):
    from emotivoice_tpu_torch.models.hifigan import ParallelResBlock1, ResBlock1, WeightNorm
    from emotivoice_tpu_torch.models.transformer import (
        ConvFFN,
        HeadParallelAttention,
        MultiHeadedAttention,
        ParallelConvFFN,
    )

    n = group.size

    def spec(leaf: str) -> Optional[int]:
        p = mod.get_parameter(leaf)
        return param_partition_spec(f"{name}.{leaf}", tuple(p.shape), n)

    if isinstance(mod, MultiHeadedAttention):
        if spec("linear_q.weight") == 0 and mod.n_heads % n == 0:
            return HeadParallelAttention(mod, group)
    elif isinstance(mod, ConvFFN):
        if spec("w_1.weight") == 0 and spec("w_2.weight") == 1:
            return ParallelConvFFN(mod, group)
    elif isinstance(mod, ResBlock1):
        if spec("convs1.0.weight_v") == 0 and spec("convs2.0.weight_v") == 1:
            return ParallelResBlock1(mod, group)
    elif isinstance(mod, WeightNorm):
        dim = spec("weight_v")
        if dim is not None:
            cls = ColumnParallel if dim == getattr(mod, "out_dim", 0) else RowParallel
            return cls(mod, group)
    return None


def _entries(module: nn.Module) -> Iterator[Tuple[str, List[torch.Tensor], Optional[int],
                                                   Optional[ModelGroup]]]:
    """(name, held parts, split dim or None, model group or None) of every
    parameter, in the order the one-device module's `named_parameters()`
    gives the whole ones."""
    for mname, mod in module.named_modules():
        prefix = mname + "." if mname else ""
        if isinstance(mod, ShardedParameters):
            for k, d in mod.layout.items():
                yield prefix + k, mod.parts(k), d, mod.group
        else:
            for k, p in mod.named_parameters(recurse=False):
                yield prefix + k, [p], None, None


def full_parameters(module: nn.Module) -> List[Tuple[str, List[torch.Tensor], Optional[int]]]:
    """(name, held parts, split dim or None) of every parameter, in the
    order the one-device module's `named_parameters()` gives the whole ones."""
    return [(name, parts, dim) for name, parts, dim, _ in _entries(module)]


def mean_replicated_grads(module: nn.Module) -> None:
    """Over a `RankGroup`: the gradients of the parameters every rank of
    the group holds whole, replaced by their mean over the group (one
    all-reduce of one flat buffer). The ranks compute them from the same
    activations, but a card's backward may add in another order from run to
    run (atomics), so each rank's copy would drift from the others' step
    by step, where JAX holds one replicated array; with equal gradients
    Adam keeps the copies bit-equal. A no-op for a module over a
    `LocalGroup` or one device."""
    entries = list(_entries(module))
    group = next((g for _, _, _, g in entries if isinstance(g, RankGroup)), None)
    if group is None:
        return
    grads = [parts[0].grad for _, parts, dim, _ in entries
             if dim is None and parts[0].grad is not None]
    if not grads:
        return
    flat = group.all_reduce(torch.cat([g.reshape(-1).float() for g in grads]))
    flat /= group.size
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def _split_state(v, dim: Optional[int]) -> bool:
    return dim is not None and torch.is_tensor(v) and v.dim() > 0


def optimizer_state_dict(opt: torch.optim.Optimizer, module: nn.Module) -> dict:
    """`opt.state_dict()` in the one-device layout of `module`, whose
    parameters `opt` holds in one group: per-parameter state tensors (Adam's
    moments) gathered whole, indices those of the whole parameters. Over a
    `RankGroup` every rank of the group must call it (it gathers)."""
    (group,) = opt.param_groups
    index = {id(p): i for i, p in enumerate(group["params"])}
    sd = opt.state_dict()
    entries = list(_entries(module))
    state = {}
    for j, (_, parts, dim, mgroup) in enumerate(entries):
        ss = [sd["state"].get(index[id(p)]) for p in parts]
        if ss[0] is not None:
            state[j] = {k: mgroup.gather([s[k] for s in ss], dim) if _split_state(v, dim) else v
                        for k, v in ss[0].items()}
    return {"state": state,
            "param_groups": [{**sd["param_groups"][0], "params": list(range(len(entries)))}]}


def load_optimizer_state_dict(opt: torch.optim.Optimizer, module: nn.Module, state: dict) -> None:
    """The inverse of `optimizer_state_dict`: a one-device layout state
    loaded into `opt` over `module`'s (possibly split) parameters, each
    held part taking its slice."""
    (group,) = opt.param_groups
    index = {id(p): i for i, p in enumerate(group["params"])}
    local = {}
    for j, (_, parts, dim, mgroup) in enumerate(_entries(module)):
        s = state["state"].get(j)
        if s is None:
            continue
        split = {k: shard_tensor(v, dim, mgroup.size) for k, v in s.items()
                 if _split_state(v, dim)}
        shards = mgroup.shards if dim is not None else [0]
        for i, p in zip(shards, parts):
            local[index[id(p)]] = {k: split[k][i] if k in split else v for k, v in s.items()}
    opt.load_state_dict({"state": local, "param_groups": [
        {**state["param_groups"][0], "params": list(range(len(group["params"])))}]})
