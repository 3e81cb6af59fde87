"""Data parallelism over the ranks of a process group (counterpart of the
'data' axis of `emotivoice_tpu/parallel/mesh.py`).

The JAX package shards the global batch over a mesh axis and XLA inserts
the gradient all-reduce into one jitted step. Here every rank runs the step
on its own rows and `DataParallel` does by hand what XLA does there: the
mean of the ranks' gradients over one flat buffer per model per backward,
the all-reduces the global batch's masked means and metrics need, and the
agreement on how many steps an epoch has. One rank (`world == 1`, no
process group) makes every method a no-op, so single-device code runs the
same lines.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Sequence, Union

import torch
import torch.distributed as dist


MAX_WIDTHS = 4  # padded sizes `agreed` can carry per step


class DataParallel:
    """This rank's place in the data-parallel group: `rank` of `world`,
    collectives on `device` (NCCL needs CUDA tensors; gloo takes CUDA or CPU
    tensors and stages CUDA ones through the host)."""

    def __init__(self, rank: int = 0, world: int = 1,
                 device: Union[str, torch.device] = "cpu"):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} is outside a world of {world}")
        if world > 1 and not dist.is_initialized():
            raise RuntimeError("a data-parallel group of several ranks needs the process "
                               "group (parallel.multihost.initialize_multihost)")
        self.rank, self.world, self.device = rank, world, torch.device(device)

    @classmethod
    def from_process_group(cls, device: Union[str, torch.device] = "cpu") -> "DataParallel":
        """The group of the initialised default process group, else one rank."""
        if dist.is_available() and dist.is_initialized():
            return cls(dist.get_rank(), dist.get_world_size(), device)
        return cls(device=device)

    def is_main(self) -> bool:
        """Rank 0: the one that logs, validates and writes checkpoints."""
        return self.rank == 0

    def local_rows(self, n_global: int) -> slice:
        """This rank's rows of a global batch of `n_global` rows."""
        if n_global % self.world:
            raise ValueError(f"a global batch of {n_global} rows does not split over "
                             f"{self.world} ranks")
        n = n_global // self.world
        return slice(self.rank * n, (self.rank + 1) * n)

    def shard_batch(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's rows of every tensor of a global batch."""
        rows = self.local_rows(len(next(iter(batch.values()))))
        return {k: v[rows] for k, v in batch.items()}

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks, in place; returns `t`."""
        if self.world > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    def mean_grads(self, params: Iterable[torch.nn.Parameter]) -> None:
        """Replace each parameter's gradient by its mean over the ranks: one
        all-reduce of one flat buffer. Parameters without a gradient have
        none on any rank (the ranks run the same graph) and are left so."""
        if self.world == 1:
            return
        grads = [p.grad for p in params if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat /= self.world
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def mean_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Scalar metrics averaged over the ranks (one all-reduce)."""
        if self.world == 1:
            return metrics
        keys = sorted(metrics)
        flat = torch.stack([metrics[k].float().reshape(()) for k in keys])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat /= self.world
        return dict(zip(keys, flat.unbind()))

    def broadcast_module(self, module: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers on every rank (one broadcast of
        one flat buffer), as DistributedDataParallel does at its start."""
        if self.world == 1:
            return
        tensors = [t.data for t in list(module.parameters()) + list(module.buffers())]
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        dist.broadcast(flat, src=0)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()

    def agreed(self, batches: Iterable,
               widths: Optional[Callable[[Any], Sequence[int]]] = None,
               pad: Optional[Callable[[Any, Sequence[int]], Any]] = None) -> Iterator:
        """`batches` for as long as every rank still has one.

        Bucketed loaders over unequal shards yield different batch counts
        per epoch, and a rank that stepped on alone would wait forever in
        the gradient all-reduce. So before each step the ranks agree, in
        one all-reduce, on whether every rank has a batch (a MIN over the
        ranks): every rank runs the smallest count of the epoch.

        With `widths(batch)` (its padded sizes) and `pad(batch, sizes)`,
        the same all-reduce takes the largest sizes of the step (a MAX) and
        each rank's batch is padded to them: the ranks then hold the rows
        of one global batch of one shape, as the JAX package's global array
        does. That matters: the model is not invariant to pad width (the
        encoder's convolutions see the padded tokens' embeddings)."""
        it = iter(batches)
        while True:
            batch = next(it, None)
            if self.world == 1:
                if batch is None:
                    return
                yield batch
                continue
            sizes = list(widths(batch)) if widths and batch is not None else []
            if len(sizes) > MAX_WIDTHS:
                raise ValueError(f"agreed() carries at most {MAX_WIDTHS} sizes, got {sizes}")
            # one MAX over [1 - have a batch, sizes...]
            msg = torch.zeros(1 + MAX_WIDTHS, dtype=torch.int64)
            msg[0] = int(batch is None)
            msg[1:1 + len(sizes)] = torch.tensor(sizes, dtype=torch.int64)
            msg = msg.to(self.device)
            dist.all_reduce(msg, op=dist.ReduceOp.MAX)
            if int(msg[0]):
                return
            agreed = [int(v) for v in msg[1:1 + len(sizes)]]
            if pad is not None and agreed != sizes:
                batch = pad(batch, agreed)
            yield batch
