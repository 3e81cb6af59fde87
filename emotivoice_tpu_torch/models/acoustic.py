"""PromptTTS acoustic model, inference branch (counterpart of
`emotivoice_tpu/models/acoustic.py`; reference
`models/prompt_tts_modified/model_open_source.py`).

phoneme embedding -> transformer encoder -> [speaker, style, content]
concat + projection -> duration / pitch / energy predictors -> Gaussian
upsampling into a static ``max_frames`` bucket -> masked transformer decoder
-> mel projection. The decoder is masked at inference too (batched bucketed
synthesis needs it; the reference runs batch 1 with h_masks=None), and the
mel is zeroed past each utterance's length.

The alignment module is carried so the state dict holds every key of a
reference checkpoint; the training branch that uses it is a later slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from emotivoice_tpu_torch.config import AcousticConfig
from emotivoice_tpu_torch.models.transformer import Linear, TransformerEncoder
from emotivoice_tpu_torch.models.variance import (
    AlignmentModule,
    DurationPredictor,
    VarianceEmbedding,
    VariancePredictor,
)
from emotivoice_tpu_torch.ops.upsample import gaussian_upsample
from emotivoice_tpu_torch.utils.masks import sequence_mask


class PromptTTS(nn.Module):
    def __init__(self, cfg: AcousticConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.src_word_emb = nn.Embedding(c.n_vocab, c.hidden)
        self.spk_tokenizer = nn.Embedding(c.n_speaker, c.hidden)
        self.encoder = TransformerEncoder(
            c.hidden, c.encoder_n_heads, c.encoder_n_layers,
            c.encoder_kernel_size, c.max_pe_len,
        )
        self.decoder = TransformerEncoder(
            c.hidden, c.decoder_n_heads, c.decoder_n_layers,
            c.decoder_kernel_size, c.max_pe_len,
        )
        self.embed_projection1 = Linear(2 * c.hidden + 2 * c.bert_embedding, c.hidden)
        self.duration_predictor = DurationPredictor(
            c.hidden, c.duration_n_layers, c.variance_n_hidden, c.duration_kernel_size,
        )
        self.pitch_predictor = VariancePredictor(
            c.hidden, c.variance_n_layers, c.variance_n_hidden, c.variance_kernel_size,
        )
        self.energy_predictor = VariancePredictor(
            c.hidden, c.energy_n_layers, c.variance_n_hidden, c.energy_kernel_size,
        )
        self.pitch_embed = VarianceEmbedding(c.hidden, c.variance_embed_kernel_size)
        self.energy_embed = VarianceEmbedding(c.hidden, c.variance_embed_kernel_size)
        self.alignment_module = AlignmentModule(c.hidden, c.n_mels)
        self.to_mel = Linear(c.hidden, c.n_mels)

    def _condition(self, tokens, text_valid, speaker, style, content, dtype):
        b, t = tokens.shape
        x = F.embedding(tokens, self.src_word_emb.weight).to(dtype)
        x = self.encoder(x, text_valid)
        spk = F.embedding(speaker, self.spk_tokenizer.weight).to(dtype)

        def tile(e):
            return e[:, None, :].expand(b, t, e.shape[-1])

        x = torch.cat(
            [x, tile(spk), tile(style.to(dtype)), tile(content.to(dtype))], dim=-1
        )
        return self.embed_projection1(x)

    def forward(
        self,
        tokens: torch.Tensor,  # (B, T_text) int
        text_lengths: torch.Tensor,  # (B,)
        speaker: torch.Tensor,  # (B,)
        style_embedding: torch.Tensor,  # (B, bert_embedding)
        content_embedding: torch.Tensor,  # (B, bert_embedding)
        *,
        max_frames: Optional[int] = None,
        alpha: float = 1.0,
        mel_targets: Optional[torch.Tensor] = None,
        dtype: torch.dtype = torch.float32,
    ) -> Dict[str, torch.Tensor]:
        if mel_targets is not None:
            raise NotImplementedError(
                "the PromptTTS training branch (alignment search, variance "
                "targets) belongs to the port's training slice"
            )
        if max_frames is None:
            raise ValueError("inference needs a static max_frames mel bucket")
        t_text = tokens.shape[1]
        text_valid = sequence_mask(text_lengths, t_text)
        x = self._condition(
            tokens, text_valid, speaker, style_embedding, content_embedding, dtype
        )
        p_outs = self.pitch_predictor(x, text_valid)
        e_outs = self.energy_predictor(x, text_valid)
        d_log = self.duration_predictor(x, text_valid)
        ds = DurationPredictor.to_durations(d_log) * text_valid.float()
        x = x + self.pitch_embed(p_outs) + self.energy_embed(e_outs)

        x, mel_lengths = gaussian_upsample(
            x, ds, text_valid, max_frames, None,
            delta=self.cfg.upsample_delta, alpha=alpha,
        )
        feat_valid = sequence_mask(mel_lengths, max_frames)
        x = self.decoder(x, feat_valid)
        mel = self.to_mel(x) * feat_valid[..., None].to(x.dtype)
        return {
            "dec_outputs": mel,
            "output_lengths": mel_lengths,
            "durations": ds,
            "pitch_predictions": p_outs,
            "energy_predictions": e_outs,
            "log_duration_predictions": d_log,
            "input_lengths": text_lengths,
        }
