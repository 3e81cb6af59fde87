"""TTS losses of the joint step (counterpart of
`emotivoice_tpu/training/losses.py`; reference
`models/prompt_tts_modified/loss.py`). The GAN losses are in
`models/discriminator.py`.

The mel term is a HiFi-GAN-style L1 between the mel of the vocoded segment
and that of the ground-truth segment: the reference's training loop puts
those two into TTSLoss's mel slots (`train_am_vocoder_joint.py:344-372`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from emotivoice_tpu_torch.ops.align import forward_sum_loss
from emotivoice_tpu_torch.utils.masks import sequence_mask


def masked_l1(pred: torch.Tensor, target: torch.Tensor, valid: torch.Tensor,
              axis_size_norm: float = 1.0,
              n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum |pred - target| over valid positions / their count. `n_valid`
    replaces the count (a data-parallel rank's share of the global one)."""
    valid = valid.to(pred.dtype)
    count = torch.clamp(torch.sum(valid), min=1.0) if n_valid is None else n_valid
    return torch.sum(torch.abs(pred - target) * valid) / (count * axis_size_norm)


def segment_mel_l1(pred_mel: torch.Tensor, gt_mel: torch.Tensor) -> torch.Tensor:
    """Mean L1 between the vocoded segment's mel and the ground truth's."""
    return torch.mean(torch.abs(pred_mel - gt_mel))


def prosody_losses(outputs: Dict[str, torch.Tensor],
                   n_valid: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Masked L1 of log durations (log(d + 1)), pitch and energy against
    the alignment's token-level targets (reference loss.py:147-185).
    `n_valid` replaces the batch's count of valid tokens (`masked_l1`)."""
    valid = sequence_mask(outputs["input_lengths"], outputs["duration_targets"].shape[1])
    log_d_target = torch.log(outputs["duration_targets"].float() + 1.0)
    return {
        "dur_loss": masked_l1(outputs["log_duration_predictions"], log_d_target, valid,
                              n_valid=n_valid),
        "pitch_loss": masked_l1(outputs["pitch_predictions"], outputs["pitch_targets"], valid,
                                n_valid=n_valid),
        "energy_loss": masked_l1(outputs["energy_predictions"], outputs["energy_targets"],
                                 valid, n_valid=n_valid),
    }


def alignment_losses(outputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    fs = forward_sum_loss(outputs["log_p_attn"], outputs["input_lengths"],
                          outputs["output_lengths"])
    return {"forwardsum_loss": fs, "bin_loss": outputs["bin_loss"]}
