"""Replicate Cog predictor over the synthesis engine (counterpart of
`emotivoice_tpu/serving/cog_predictor.py`).

Parity target: reference `predict.py:99-234` — a `Predictor` with
`setup()` loading the models once and `predict(prompt, content, language,
speaker)` returning a wav file path. Differences by design:

  - weights load from local paths (the reference pget-downloads
    `g_00140000`/`checkpoint_163431` from a CDN at setup, predict.py:30-55;
    hermetic deployments ship weights in the image instead);
  - synthesis runs through `SynthesisEngine` (batched, bucketed) rather
    than a bare model call;
  - works without the `cog` package: `BasePredictor`/`Input`/`Path` degrade
    to plain-Python equivalents, so the same class serves as a simple
    programmatic one-shot API. (The reference's predictor has a latent
    import bug — `frontend_en.preprocess_english` does not exist,
    predict.py:18 — ours is tested.)

Cog deployment: `predict: "emotivoice_tpu_torch/serving/cog_predictor.py:Predictor"`
in cog.yaml.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

try:  # pragma: no cover - optional dependency
    from cog import BasePredictor, Input, Path
except ImportError:
    BasePredictor = object

    def Input(description: str = "", default=None, choices=None):  # noqa: N802
        return default

    Path = str  # type: ignore


class Predictor(BasePredictor):
    """One-utterance TTS predictor (Cog-compatible)."""

    def setup(
        self,
        checkpoint: Optional[str] = None,
        style_encoder: Optional[str] = None,
        tokenizer: Optional[str] = None,
        tokenlist: Optional[str] = None,
        speakers: Optional[str] = None,
        lexicon: Optional[str] = None,
        engine=None,
        device=None,
    ) -> None:
        """Load models once. Pass an existing SynthesisEngine (tests) or
        checkpoint paths (deployment; env vars EMOTIVOICE_* as defaults).
        `device` defaults to 'cuda' and raises without a card."""
        from emotivoice_tpu_torch.config import EmotiVoiceConfig
        from emotivoice_tpu_torch.frontend.en import read_lexicon
        from emotivoice_tpu_torch.frontend.tokens import load_label_list
        from emotivoice_tpu_torch.serving.loading import (
            build_embed_fn,
            build_generator,
            config_and_vocab,
        )

        env = os.environ.get
        checkpoint = checkpoint or env("EMOTIVOICE_CHECKPOINT")
        style_encoder = style_encoder or env("EMOTIVOICE_STYLE_ENCODER")
        tokenlist = tokenlist or env("EMOTIVOICE_TOKENLIST")
        speakers = speakers or env("EMOTIVOICE_SPEAKERS")
        lexicon = lexicon or env("EMOTIVOICE_LEXICON")

        cfg, vocab = config_and_vocab(EmotiVoiceConfig(), tokenlist)
        speaker_list = (
            load_label_list(speakers)
            if speakers
            else [str(i) for i in range(cfg.am.n_speaker)]
        )
        self.speaker2id = {s: i for i, s in enumerate(speaker_list)}
        self.lexicon = read_lexicon(lexicon) if lexicon else None

        if engine is not None:
            self.engine = engine
        else:
            from emotivoice_tpu_torch.serving.engine import SynthesisEngine

            assert checkpoint, "checkpoint path required (EMOTIVOICE_CHECKPOINT)"
            self.engine = SynthesisEngine(
                cfg, build_generator(cfg, checkpoint), vocab, device=device)
        self.embed_fn = build_embed_fn(cfg, style_encoder, tokenizer, self.engine.device)

    def predict(
        self,
        prompt: str = Input(description="Style prompt", default="Happy"),
        content: str = Input(
            description="Input text",
            default="Emoti-Voice - a Multi-Voice and Prompt-Controlled "
                    "T-T-S Engine",
        ),
        language: str = Input(
            description="Language", choices=["English", "Chinese"],
            default="English",
        ),
        speaker: str = Input(description="speakers", default="8051"),
    ) -> Path:
        """Synthesize one utterance -> wav file path (reference
        predict.py:196-234, including the language/content guard)."""
        from emotivoice_tpu_torch.frontend.cn import g2p_cn
        from emotivoice_tpu_torch.frontend.en import get_eng_phoneme
        from emotivoice_tpu_torch.frontend.mixed import contains_chinese
        from emotivoice_tpu_torch.serving.engine import SynthesisRequest
        from emotivoice_tpu_torch.utils.audio_io import write_wav

        if language == "English":
            if contains_chinese(content):
                raise ValueError(
                    "input text contains Chinese, but language is English"
                )
            phonemes = get_eng_phoneme(
                content, self.lexicon, pad_sos_eos=True
            ).split()
        else:
            if not contains_chinese(content):
                raise ValueError(
                    "input text contains English, but language is Chinese"
                )
            phonemes = g2p_cn(content).split()

        if speaker not in self.speaker2id:
            raise ValueError(f"unknown speaker {speaker!r}")
        result = self.engine.synthesize(
            SynthesisRequest(
                phonemes=phonemes,
                speaker_id=self.speaker2id[speaker],
                style_embedding=self.embed_fn(prompt),
                content_embedding=self.embed_fn(content),
            )
        )
        out = os.path.join(tempfile.mkdtemp(), "out.wav")
        write_wav(out, result.wav, self.engine.sr)
        return Path(out)
