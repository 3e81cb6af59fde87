"""PromptTTS acoustic model (counterpart of
`emotivoice_tpu/models/acoustic.py`; reference
`models/prompt_tts_modified/model_open_source.py`).

phoneme embedding -> transformer encoder -> [speaker, style, content]
concat + projection -> duration / pitch / energy predictors -> Gaussian
upsampling -> masked transformer decoder -> mel projection; the mel is
zeroed past each utterance's length.

Inference (no `mel_targets`) upsamples into a static ``max_frames`` bucket
by the predicted durations; the decoder is masked there too (batched
bucketed synthesis needs it; the reference runs batch 1 with h_masks=None).
Training takes durations from the alignment: the alignment module scores
text against the target mel, the beta-binomial prior is added, monotonic
alignment search gives the path and durations, pitch and energy targets are
averaged per token over the path, and the decoder runs at the target's
length. The search runs on the tensors' device (`ops/align.py`).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

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
from emotivoice_tpu_torch.ops.align import average_by_path, beta_binomial_prior, viterbi_decode
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
            c.encoder_kernel_size, c.max_pe_len, c.encoder_p_dropout,
        )
        self.decoder = TransformerEncoder(
            c.hidden, c.decoder_n_heads, c.decoder_n_layers,
            c.decoder_kernel_size, c.max_pe_len, c.decoder_p_dropout,
        )
        self.embed_projection1 = Linear(2 * c.hidden + 2 * c.bert_embedding, c.hidden)
        self.duration_predictor = DurationPredictor(
            c.hidden, c.duration_n_layers, c.variance_n_hidden, c.duration_kernel_size,
            c.duration_p_dropout,
        )
        self.pitch_predictor = VariancePredictor(
            c.hidden, c.variance_n_layers, c.variance_n_hidden, c.variance_kernel_size,
            c.variance_p_dropout,
        )
        self.energy_predictor = VariancePredictor(
            c.hidden, c.energy_n_layers, c.variance_n_hidden, c.energy_kernel_size,
            c.variance_p_dropout,
        )
        self.pitch_embed = VarianceEmbedding(
            c.hidden, c.variance_embed_kernel_size, c.variance_embed_p_dropout)
        self.energy_embed = VarianceEmbedding(
            c.hidden, c.variance_embed_kernel_size, c.variance_embed_p_dropout)
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
        alpha: Union[float, torch.Tensor] = 1.0,
        mel_targets: Optional[torch.Tensor] = None,  # (B, T_feats, n_mels)
        feats_lengths: Optional[torch.Tensor] = None,  # (B,)
        pitch_targets: Optional[torch.Tensor] = None,  # (B, T_feats) frame level
        energy_targets: Optional[torch.Tensor] = None,  # (B, T_feats)
        dtype: torch.dtype = torch.float32,
    ) -> Dict[str, torch.Tensor]:
        training = mel_targets is not None
        if training and (feats_lengths is None or pitch_targets is None
                         or energy_targets is None):
            raise ValueError("the training branch needs feats_lengths, pitch_targets "
                             "and energy_targets beside mel_targets")
        if not training and max_frames is None:
            raise ValueError("inference needs a static max_frames mel bucket")
        t_text = tokens.shape[1]
        text_valid = sequence_mask(text_lengths, t_text)
        x = self._condition(
            tokens, text_valid, speaker, style_embedding, content_embedding, dtype
        )
        out: Dict[str, torch.Tensor] = {"input_lengths": text_lengths}
        p_outs = self.pitch_predictor(x, text_valid)
        e_outs = self.energy_predictor(x, text_valid)
        d_outs = self.duration_predictor(x, text_valid)
        if training:
            t_feats = mel_targets.shape[1]
            feat_valid = sequence_mask(feats_lengths, t_feats)
            # f32 in any compute dtype: the JAX module has no dtype, so its
            # bf16 text input meets f32 weights and f32 mel targets in f32
            log_p_attn = self.alignment_module(x.float(), mel_targets.float(), text_valid)
            log_p_attn = log_p_attn + beta_binomial_prior(
                text_lengths, feats_lengths, t_text, t_feats)
            ds, bin_loss, path = viterbi_decode(log_p_attn, text_lengths, feats_lengths)
            ps = average_by_path(path, pitch_targets, text_lengths, feats_lengths, t_text)
            es = average_by_path(path, energy_targets, text_lengths, feats_lengths, t_text)
            x = x + self.pitch_embed(ps.to(dtype)) + self.energy_embed(es.to(dtype))
            x, _ = gaussian_upsample(
                x, ds, text_valid, t_feats, feat_valid,
                delta=self.cfg.upsample_delta, alpha=alpha,
            )
            mel_lengths = feats_lengths
            out.update(log_p_attn=log_p_attn, bin_loss=bin_loss, duration_targets=ds,
                       pitch_targets=ps, energy_targets=es, alignment_path=path)
        else:
            ds = DurationPredictor.to_durations(d_outs) * text_valid.float()
            x = x + self.pitch_embed(p_outs) + self.energy_embed(e_outs)
            x, mel_lengths = gaussian_upsample(
                x, ds, text_valid, max_frames, None,
                delta=self.cfg.upsample_delta, alpha=alpha,
            )
            feat_valid = sequence_mask(mel_lengths, max_frames)
            out["durations"] = ds
        x = self.decoder(x, feat_valid)
        mel = self.to_mel(x) * feat_valid[..., None].to(x.dtype)
        out.update(
            dec_outputs=mel,
            output_lengths=mel_lengths,
            pitch_predictions=p_outs,
            energy_predictions=e_outs,
            log_duration_predictions=d_outs,
        )
        return out
