"""Style/content embedding service: text -> SimBERT pooler vector
(counterpart of `emotivoice_tpu/serving/style.py`).

Reference `get_style_embedding` (`inference_am_vocoder_joint.py:27-37`): HF
tokenizer -> BERT -> pooler_output. The tokenizer stays on the host; the
BERT forward runs on the embedder's device, batched over prompt strings.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from emotivoice_tpu_torch.config import StyleBertConfig
from emotivoice_tpu_torch.convert.from_reference import load_checkpoint, load_style_encoder
from emotivoice_tpu_torch.models.bert import StyleEncoder
from emotivoice_tpu_torch.utils.device import resolve_device


class StyleEmbedder:
    """`tokenizer` is any callable with the HF tokenizer call signature
    (`tokenizer(texts, padding=, truncation=, max_length=, return_tensors=
    "np")` -> mapping with `input_ids`, `attention_mask` and optionally
    `token_type_ids`). `device` defaults to 'cuda' and raises without a
    card; pass 'cpu' for the CPU."""

    def __init__(
        self,
        model: StyleEncoder,
        cfg: StyleBertConfig,
        tokenizer=None,
        max_len: int = 64,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.max_len = max_len

    @classmethod
    def from_checkpoint(
        cls,
        ckpt_path: str,
        cfg: StyleBertConfig,
        tokenizer_path: Optional[str] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "StyleEmbedder":
        """Reference style-encoder checkpoint: `{'model': state_dict}` with
        DataParallel `module.` prefixes, HF BERT key names."""
        model = load_style_encoder(StyleEncoder(cfg), load_checkpoint(ckpt_path))
        tokenizer = None
        if tokenizer_path:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(tokenizer_path)
        return cls(model, cfg, tokenizer, device=device)

    def _tokenize(self, texts: List[str]):
        assert self.tokenizer is not None, (
            "StyleEmbedder needs a tokenizer (pass tokenizer_path pointing at "
            "the simbert vocab) for raw-text input"
        )
        enc = self.tokenizer(
            texts,
            padding="max_length",
            truncation=True,
            max_length=self.max_len,
            return_tensors="np",
        )
        ids = np.asarray(enc["input_ids"])
        type_ids = enc.get("token_type_ids", np.zeros_like(ids))
        return ids, np.asarray(type_ids), np.asarray(enc["attention_mask"])

    def embed_batch(self, texts: List[str]) -> np.ndarray:
        """(len(texts), hidden_size) f32 numpy. Safe to call from any thread:
        inference mode is entered here, since it is a per-thread state."""
        ids, type_ids, mask = self._tokenize(texts)
        with torch.inference_mode():
            out = self.model(*(
                torch.as_tensor(a, dtype=torch.long, device=self.device)
                for a in (ids, type_ids, mask)
            ))
            return out["pooled_output"].float().cpu().numpy()

    def embed(self, text: str) -> np.ndarray:
        return self.embed_batch([text])[0]
