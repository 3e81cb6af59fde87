"""Style-encoder (SimBERT) pretraining: attribute classification
(counterpart of `emotivoice_tpu/training/style_pretrain.py`; reference
`simbert.py:76-115`, `StylePretrainLoss`, `StylePretrainLoss2`,
`flat_accuracy`).

Per-prompt cross-entropy on the pitch / speed / energy / emotion label
vocabularies, summed, with the encoder's dropouts active (`train()`). The
optimizer is exactly the JAX package's `optax.adamw(2e-5)`: betas (0.9,
0.999), eps 1e-8 and a decoupled weight decay of 1e-4 (torch's AdamW would
default to 1e-2). f32: TF32 is turned off for the run.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from emotivoice_tpu_torch.utils.device import resolve_device, use_exact_f32

ATTRIBUTES = ("pitch", "speed", "energy", "emotion")
ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)  # optax.adamw's defaults


def style_pretrain_loss(outputs: Dict[str, torch.Tensor],
                        labels: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Mean cross-entropy of each attribute head (reference StylePretrainLoss)."""
    return {f"{a}_loss": F.cross_entropy(outputs[f"{a}_outputs"].float(), labels[a])
            for a in ATTRIBUTES}


def flat_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Share of rows whose argmax is the label (reference simbert.py:109-115)."""
    return (torch.argmax(logits, dim=-1) == labels).float().mean()


def _to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch of ids, masks and labels (numpy or tensors) as int64 tensors."""
    return {k: torch.as_tensor(v, device=device).long() for k, v in batch.items()}


class PretrainStep:
    """`__call__(batch)`: one AdamW update of `model` (a `StyleEncoder`) on
    a batch with input_ids, attention_mask, optional token_type_ids and the
    four label vectors; returns the losses, accuracies and their sum as
    detached scalars on the device."""

    def __init__(self, model: nn.Module, learning_rate: float = 2e-5):
        self.model = model
        self.opt = torch.optim.AdamW(model.parameters(), lr=learning_rate, **ADAMW)

    def __call__(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        self.model.train()
        out = self.model(batch["input_ids"], batch.get("token_type_ids"),
                         batch["attention_mask"])
        losses = style_pretrain_loss(out, batch)
        total = sum(losses.values())
        self.opt.zero_grad(set_to_none=True)
        total.backward()
        self.opt.step()
        accs = {f"{a}_acc": flat_accuracy(out[f"{a}_outputs"].detach(), batch[a])
                for a in ATTRIBUTES}
        return {**{k: v.detach() for k, v in losses.items()}, **accs, "loss": total.detach()}


def pretrain(
    model: nn.Module,
    batches: Iterable[Dict],
    total_steps: int,
    learning_rate: float = 2e-5,
    log_every: int = 50,
    logger=None,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
) -> nn.Module:
    """Run attribute-classification pretraining on `device` (None: the
    card) for at most `total_steps` batches; returns the trained model.
    Every `log_every` steps the metrics go to `logger.log(step, metrics,
    prefix="style_pretrain")`, or are printed without a logger. `seed`
    seeds torch's RNG (the dropout masks)."""
    device = resolve_device(device)
    use_exact_f32(torch.float32)
    torch.manual_seed(seed)
    step_fn = PretrainStep(model.to(device), learning_rate)
    n = 0
    for batch in batches:
        metrics = step_fn(_to_device(batch, device))
        n += 1
        if n % log_every == 0:
            line = {k: float(v) for k, v in metrics.items()}
            if logger is not None:
                logger.log(n, line, prefix="style_pretrain")
            else:
                print(f"step {n}: " + " ".join(f"{k}={v:.4f}" for k, v in sorted(line.items())),
                      flush=True)
        if n >= total_steps:
            break
    return model
