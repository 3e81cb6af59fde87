"""JETS joint model, inference: PromptTTS acoustic model + HiFi-GAN
generator (counterpart of `emotivoice_tpu/models/jets.py`; reference
`models/prompt_tts_modified/jets.py:26-71`). Inference vocodes the full
bucketed mel (the JAX model's `cut=False`); the training crop is a later
slice.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from emotivoice_tpu_torch.config import EmotiVoiceConfig
from emotivoice_tpu_torch.models.acoustic import PromptTTS
from emotivoice_tpu_torch.models.hifigan import (
    HiFiGANGenerator,
    WNConvTranspose1d,
    WeightNorm,
)


class JETSGenerator(nn.Module):
    def __init__(self, cfg: EmotiVoiceConfig):
        super().__init__()
        self.cfg = cfg
        self.am = PromptTTS(cfg.am)
        self.generator = HiFiGANGenerator(cfg.vocoder)

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
        max_frames: int,
        alpha: float = 1.0,
        dtype: torch.dtype = torch.float32,
    ) -> Dict[str, torch.Tensor]:
        """`dtype` is the compute dtype (float32 or bfloat16); parameters
        stay f32 and the waveform leaves f32."""
        out = self.am(
            tokens, text_lengths, speaker, style_embedding, content_embedding,
            max_frames=max_frames, alpha=alpha, dtype=dtype,
        )
        out["wav_predictions"] = self.generator(out["dec_outputs"], dtype=dtype)
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
            v = mod.weight_v
            mod.weight_g.copy_(torch.sqrt(torch.sum(v * v, dim=(1, 2), keepdim=True)))
    return model
