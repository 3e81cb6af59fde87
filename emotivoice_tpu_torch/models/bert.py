"""SimBERT-style sentence encoder (standard BERT), counterpart of
`emotivoice_tpu/models/bert.py`.

Parity target: reference `models/prompt_tts_modified/simbert.py:33-72`, a HF
`AutoModel` BERT whose `pooler_output` (tanh(dense(CLS))) is the style /
content embedding, plus four classification heads used only for
style-encoder pretraining.

Parameter names are HF BERT's (`bert.embeddings.word_embeddings.weight`,
`bert.encoder.layer.{i}.attention.self.query.*`, ..., `bert.pooler.dense`,
`{pitch,speed,energy,emotion}_clf.classifier`), so a reference
`checkpoint_163431` state dict loads as it is and this module's own
`state_dict()` converts through `convert_style_encoder` of the JAX package
unchanged. BERT's five dropouts (embeddings, attention probabilities,
attention output, feed-forward output, each classification head at 0.1)
are active in `train()` only, for style-encoder pretraining
(`training/style_pretrain.py`); in `eval()` they are the identity.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from emotivoice_tpu_torch.config import StyleBertConfig
from emotivoice_tpu_torch.utils.masks import NEG_INF

LN_EPS = 1e-12


class BertSelfAttention(nn.Module):
    """Full attention as explicit matmul + softmax. The mask is on keys only
    (padded queries still produce rows); scores are scaled after the product,
    in f32."""

    def __init__(self, cfg: StyleBertConfig):
        super().__init__()
        self.n_heads = cfg.num_heads
        self.d_head = cfg.hidden_size // cfg.num_heads
        self.query = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.key = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.value = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.dropout = nn.Dropout(cfg.attention_dropout)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, t, d = x.shape

        def split(h):  # (B, T, D) -> (B, H, T, d_head)
            return h.view(b, t, self.n_heads, self.d_head).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        scores = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(self.d_head)
        if key_mask is not None:
            scores = scores.masked_fill(~key_mask[:, None, None, :], NEG_INF)
        probs = self.dropout(torch.softmax(scores, dim=-1))
        out = torch.matmul(probs.to(v.dtype), v)
        return out.transpose(1, 2).reshape(b, t, d)


class _SelfOutput(nn.Module):
    """dense, dropout, residual LayerNorm (HF `BertSelfOutput` / `BertOutput`)."""

    def __init__(self, d_in: int, d_out: int, p_dropout: float):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        self.dropout = nn.Dropout(p_dropout)
        self.LayerNorm = nn.LayerNorm(d_out, eps=LN_EPS)

    def forward(self, h: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(residual + self.dropout(self.dense(h)))


class _Attention(nn.Module):
    def __init__(self, cfg: StyleBertConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = _SelfOutput(cfg.hidden_size, cfg.hidden_size, cfg.hidden_dropout)

    def forward(self, x, key_mask):
        return self.output(self.self(x, key_mask), x)


class _Intermediate(nn.Module):
    def __init__(self, cfg: StyleBertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x):
        return F.gelu(self.dense(x), approximate="none")  # exact erf form


class BertLayer(nn.Module):
    def __init__(self, cfg: StyleBertConfig):
        super().__init__()
        self.attention = _Attention(cfg)
        self.intermediate = _Intermediate(cfg)
        self.output = _SelfOutput(cfg.intermediate_size, cfg.hidden_size, cfg.hidden_dropout)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor]) -> torch.Tensor:
        x = self.attention(x, key_mask)
        return self.output(self.intermediate(x), x)


class _Embeddings(nn.Module):
    def __init__(self, cfg: StyleBertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, input_ids, token_type_ids):
        pos_ids = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        x = (self.word_embeddings(input_ids) + self.position_embeddings(pos_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.LayerNorm(x))


class _Encoder(nn.Module):
    def __init__(self, cfg: StyleBertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_layers))


class _Pooler(nn.Module):
    def __init__(self, cfg: StyleBertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x):
        return torch.tanh(self.dense(x[:, 0]))


class BertModel(nn.Module):
    def __init__(self, cfg: StyleBertConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.pooler = _Pooler(cfg)

    def forward(
        self,
        input_ids: torch.Tensor,  # (B, T) int64
        token_type_ids: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,  # (B, T) 1 = valid
    ) -> Dict[str, torch.Tensor]:
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.embeddings(input_ids, token_type_ids)
        key_mask = attention_mask.bool() if attention_mask is not None else None
        for layer in self.encoder.layer:
            x = layer(x, key_mask)
        return {"last_hidden_state": x, "pooler_output": self.pooler(x)}


class _Head(nn.Module):
    """Dropout 0.1 on the pooled output (each head its own), then a Linear."""

    def __init__(self, d_in: int, n_labels: int):
        super().__init__()
        self.dropout = nn.Dropout(0.1)
        self.classifier = nn.Linear(d_in, n_labels)

    def forward(self, x):
        return self.classifier(self.dropout(x))


class StyleEncoder(nn.Module):
    """BERT + pretraining classification heads (reference simbert.py:33-72)."""

    def __init__(self, cfg: StyleBertConfig):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(cfg)
        self.pitch_clf = _Head(cfg.hidden_size, cfg.pitch_n_labels)
        self.speed_clf = _Head(cfg.hidden_size, cfg.speed_n_labels)
        self.energy_clf = _Head(cfg.hidden_size, cfg.energy_n_labels)
        self.emotion_clf = _Head(cfg.hidden_size, cfg.emotion_n_labels)

    def forward(self, input_ids, token_type_ids=None,
                attention_mask=None) -> Dict[str, torch.Tensor]:
        pooled = self.bert(input_ids, token_type_ids, attention_mask)["pooler_output"]
        return {
            "pooled_output": pooled,
            "pitch_outputs": self.pitch_clf(pooled),
            "speed_outputs": self.speed_clf(pooled),
            "energy_outputs": self.energy_clf(pooled),
            "emotion_outputs": self.emotion_clf(pooled),
        }
