"""What the port's entry points (`serve`, `synthesize`, the Cog predictor)
share when they set a model up: config + vocabulary, generator weights from
a reference checkpoint or a seed, and the embedding function."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from emotivoice_tpu_torch.config import EmotiVoiceConfig
from emotivoice_tpu_torch.convert.from_reference import load_checkpoint, load_jets_generator
from emotivoice_tpu_torch.frontend.tokens import TokenVocab
from emotivoice_tpu_torch.models.jets import JETSGenerator, init_random_


def config_and_vocab(cfg: EmotiVoiceConfig,
                     tokenlist: Optional[str] = None) -> Tuple[EmotiVoiceConfig, TokenVocab]:
    """The vocabulary (file or the built-in default) and `cfg` with its
    `am.n_vocab` set to the vocabulary's size."""
    vocab = TokenVocab.from_file(tokenlist) if tokenlist else TokenVocab.default()
    return cfg.replace(am=cfg.am.__class__(**{**cfg.am.__dict__, "n_vocab": len(vocab)})), vocab


def config_with_tables(cfg: EmotiVoiceConfig, generator_state: dict) -> EmotiVoiceConfig:
    """`cfg` with the speaker and token table sizes of a generator state
    dict (a checkpoint's tables are authoritative: a corpus-local run trains
    fewer speakers and tokens than the 2014 / 502 defaults)."""
    return cfg.replace(am=cfg.am.__class__(**{
        **cfg.am.__dict__, "n_speaker": generator_state["am.spk_tokenizer.weight"].shape[0],
        "n_vocab": generator_state["am.src_word_emb.weight"].shape[0]}))


def build_generator(cfg: EmotiVoiceConfig, checkpoint: Optional[str] = None,
                    seed: int = 0) -> JETSGenerator:
    """A `JETSGenerator` from a reference ``g_*`` checkpoint, or in smoke
    mode (no checkpoint) with random parameters made from `seed`."""
    model = JETSGenerator(cfg)
    if checkpoint:
        return load_jets_generator(model, load_checkpoint(checkpoint))
    print(f"WARNING: no checkpoint; random parameters from seed {seed} (smoke mode)")
    return init_random_(model, seed)


def build_embed_fn(cfg: EmotiVoiceConfig, style_encoder: Optional[str] = None,
                   tokenizer: Optional[str] = None,
                   device=None) -> Callable[[str], np.ndarray]:
    """text -> (bert_embedding,) f32: the SimBERT style encoder from a
    reference checkpoint, or zeros in smoke mode (no style encoder)."""
    if style_encoder:
        from emotivoice_tpu_torch.serving.style import StyleEmbedder

        return StyleEmbedder.from_checkpoint(style_encoder, cfg.bert, tokenizer, device).embed
    print("WARNING: no style encoder; zero style embeddings (smoke mode)")
    zeros = np.zeros(cfg.am.bert_embedding, np.float32)
    return lambda text: zeros
