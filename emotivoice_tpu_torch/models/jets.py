"""JETS joint model: PromptTTS acoustic model + HiFi-GAN generator
(counterpart of `emotivoice_tpu/models/jets.py`; reference
`models/prompt_tts_modified/jets.py:26-71`). Training (`mel_targets` given,
`cut=True`) vocodes a random `segment_size`-frame crop of the decoder
output; inference and validation (`cut=False`) vocode the whole mel.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Union

import torch
from torch import nn

from emotivoice_tpu_torch.config import EmotiVoiceConfig
from emotivoice_tpu_torch.models.acoustic import PromptTTS
from emotivoice_tpu_torch.models.hifigan import (
    HiFiGANGenerator,
    WNConvTranspose1d,
    WeightNorm,
    _norm_except_dim0,
)
from emotivoice_tpu_torch.ops.segments import get_random_segments


class JETSGenerator(nn.Module):
    """`kernels` is the vocoder's switch (`HiFiGANGenerator`): True for
    serving, synthesis and validation, False for the trainer, whose
    backward the kernels do not have."""

    def __init__(self, cfg: EmotiVoiceConfig, kernels: bool = True):
        super().__init__()
        self.cfg = cfg
        self.am = PromptTTS(cfg.am)
        self.generator = HiFiGANGenerator(cfg.vocoder, kernels)

    @property
    def upsample_factor(self) -> int:
        return self.cfg.vocoder.upsample_factor

    def forward(
        self,
        tokens: torch.Tensor,
        text_lengths: torch.Tensor,
        speaker: torch.Tensor,
        style_embedding: torch.Tensor,
        content_embedding: torch.Tensor,
        *,
        max_frames: Optional[int] = None,
        alpha: Union[float, torch.Tensor] = 1.0,
        dtype: torch.dtype = torch.float32,
        mel_targets: Optional[torch.Tensor] = None,
        feats_lengths: Optional[torch.Tensor] = None,
        pitch_targets: Optional[torch.Tensor] = None,
        energy_targets: Optional[torch.Tensor] = None,
        cut: bool = True,
        start_idxs: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        """`dtype` is the compute dtype (float32 or bfloat16); parameters
        stay f32 and the waveform leaves f32. `alpha` (duration scale,
        1 / speed) is a float or a 0-d tensor on the model's device. In
        training with `cut`, the crop starts at `start_idxs` (the trainer
        draws them), or at frames drawn from torch's global generator when
        none are given."""
        out = self.am(
            tokens, text_lengths, speaker, style_embedding, content_embedding,
            max_frames=max_frames, alpha=alpha, mel_targets=mel_targets,
            feats_lengths=feats_lengths, pitch_targets=pitch_targets,
            energy_targets=energy_targets, dtype=dtype,
        )
        z = out["dec_outputs"]
        out["z_start_idxs"] = None
        if mel_targets is not None and cut:
            z, out["z_start_idxs"] = get_random_segments(
                z, out["output_lengths"], self.cfg.train.segment_size, start_idxs=start_idxs)
        out["wav_predictions"] = self.generator(z, dtype=dtype)
        return out


@torch.no_grad()
def init_random_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Random parameters from a seed (smoke mode, no checkpoint).

    Embeddings ~ N(0, 1); every other weight ~ N(0, 1/fan_in) so activations
    stay O(1) through the whole path; weight-norm g = ||v|| (as at the
    reference's init); biases 0, LayerNorm scale 1, positional alpha 1."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        for leaf, p in mod.named_parameters(recurse=False):
            if leaf == "bias":
                p.zero_()
            elif leaf == "weight_g":
                continue  # from weight_v below
            elif p.dim() <= 1:  # LayerNorm scale, positional alpha
                p.fill_(1.0)
            elif isinstance(mod, nn.Embedding):
                p.copy_(torch.randn(p.shape, generator=gen))
            else:
                fan_in = p[0].numel()
                if isinstance(mod, WNConvTranspose1d):  # (Ci, Co, K)
                    fan_in = p.shape[0] * p.shape[2] // mod.stride
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(fan_in))
        if isinstance(mod, WeightNorm):
            mod.weight_g.copy_(_norm_except_dim0(mod.weight_v))
    return model
