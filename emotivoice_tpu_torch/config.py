"""Typed configuration tree for the PyTorch port (emotivoice_tpu_torch).

The port keeps its own copy of the JAX package's `emotivoice_tpu/config.py`
so that it imports nothing of that package; the two trees stay field for
field identical, so a config built for one describes the same model in the
other.

One dataclass tree replaces the reference's three config mechanisms (generated
`Config` classes, yacs YAML, argparse) — see reference
`config/joint/config.py:32-115` and `config/joint/config.yaml`.

Defaults reproduce the reference's released architecture:
  - audio: 16 kHz / n_fft 1024 / hop 256 / 80 mel / fmax 8k
    (reference `config/joint/config.py:89-103`)
  - acoustic model: 4+4 layer 384-d transformer, 8 heads
    (reference `config/joint/config.yaml` model section)
  - vocoder: HiFi-GAN V1 topology 512->32ch, rates 8,8,2,2
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    sampling_rate: int = 16_000
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    window: str = "hann"
    n_mels: int = 80
    fmin: float = 0.0
    fmax: float = 8000.0
    # Pitch extraction range in Hz (reference config/joint/config.py:106-107).
    pitch_min: float = 80.0
    pitch_max: float = 400.0
    # Corpus z-score stats (reference config/joint/config.py:108,111).
    pitch_stats: Tuple[float, float] = (225.089, 53.78)
    energy_stats: Tuple[float, float] = (30.610, 21.78)
    # "jax" = on-device NAC extractor (ops/pitch.py, default); "pyworld" =
    # exact reference DIO+StoneMask on host (optional dependency) for users
    # who want bit-level reference pitch targets (feats.py:115-130).
    pitch_backend: str = "jax"

    @property
    def frames_per_second(self) -> float:
        return self.sampling_rate / self.hop_length


@dataclasses.dataclass(frozen=True)
class AcousticConfig:
    """PromptTTS acoustic model (reference model_open_source.py:18-100)."""

    n_vocab: int = 502
    n_speaker: int = 2014
    hidden: int = 384
    bert_embedding: int = 768

    encoder_n_layers: int = 4
    encoder_n_heads: int = 8
    encoder_p_dropout: float = 0.2
    encoder_kernel_size: int = 3

    decoder_n_layers: int = 4
    decoder_n_heads: int = 8
    decoder_p_dropout: float = 0.2
    decoder_kernel_size: int = 3

    variance_n_hidden: int = 384
    variance_n_layers: int = 3  # pitch predictor layers
    variance_kernel_size: int = 3
    variance_p_dropout: float = 0.1
    variance_embed_kernel_size: int = 9
    variance_embed_p_dropout: float = 0.0

    duration_n_layers: int = 2
    duration_kernel_size: int = 3
    duration_p_dropout: float = 0.5

    energy_n_layers: int = 2  # hard-coded 2 in reference model_open_source.py:74
    energy_kernel_size: int = 3

    n_mels: int = 80
    # Gaussian upsampling temperature (reference alignment.py:177).
    upsample_delta: float = 0.1
    # Positional-encoding table length (reference encoder.py:206 max_len=5000).
    max_pe_len: int = 5000


@dataclasses.dataclass(frozen=True)
class VocoderConfig:
    """HiFi-GAN generator (reference models/hifigan/models.py:90-140)."""

    resblock: str = "1"
    initial_channel: int = 80
    upsample_initial_channel: int = 512
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    )
    lrelu_slope: float = 0.1

    @property
    def upsample_factor(self) -> int:
        out = 1
        for r in self.upsample_rates:
            out *= r
        return out


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    """MPD + MSD discriminator topology (reference models/hifigan/models.py:143-263).

    Defaults reproduce the reference exactly; tests/dryruns shrink the
    towers (the full discriminator is ~70M params — by far the largest
    compile unit in the GAN step).
    """

    periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    # Channel progression of the 4 strided k(5,1) towers in DiscriminatorP
    # (reference models.py:150-156); a 5th stride-1 layer at the last width
    # and a 1-channel conv_post follow.
    period_channels: Tuple[int, ...] = (32, 128, 512, 1024)
    period_kernel_size: int = 5
    period_stride: int = 3
    # Number of MSD scales (1x, 2x, 4x avg-pooled); the first uses spectral
    # norm (reference models.py:236-263).
    n_scales: int = 3
    # DiscriminatorS stack: (out_ch, kernel, stride, groups, pad) per layer
    # (reference models.py:210-218); a 1-channel k3 conv_post follows.
    scale_layers: Tuple[Tuple[int, int, int, int, int], ...] = (
        (128, 15, 1, 1, 7),
        (128, 41, 2, 4, 20),
        (256, 41, 2, 16, 20),
        (512, 41, 4, 16, 20),
        (1024, 41, 4, 16, 20),
        (1024, 41, 1, 16, 20),
        (1024, 5, 1, 1, 2),
    )


@dataclasses.dataclass(frozen=True)
class StyleBertConfig:
    """SimBERT-style sentence encoder (reference simbert.py:33-72).

    Architecture matches `WangZeJun/simbert-base-chinese` (standard BERT base).
    """

    vocab_size: int = 13685
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    # classification heads used during style-encoder pretraining
    pitch_n_labels: int = 3
    speed_n_labels: int = 3
    energy_n_labels: int = 3
    emotion_n_labels: int = 7
    style_dim: int = 128


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Joint AM+vocoder GAN training (reference train_am_vocoder_joint.py)."""

    batch_size: int = 16
    lr: float = 1.25e-5
    betas: Tuple[float, float] = (0.5, 0.9)
    eps: float = 1e-9
    weight_decay: float = 0.0
    lr_gamma_per_epoch: float = 0.999875
    segment_size: int = 32  # mel frames cropped before vocoding
    # Loss weights (reference train_am_vocoder_joint.py:402-414).
    w_mel: float = 45.0
    w_dur: float = 1.0
    w_pitch: float = 1.0
    w_energy: float = 1.0
    w_forwardsum: float = 2.0
    w_bin: float = 2.0
    w_adv: float = 1.0
    w_fm: float = 1.0
    seed: int = 1234
    iters_per_validation: int = 1000
    iters_per_checkpoint: int = 10000
    grad_clip: Optional[float] = None  # reference applies none


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh / sharding layout.

    The model (~37M params) fits one chip, so the default is pure data
    parallelism over the 'data' axis; the 'model' axis exists for TP of the
    vocoder channels / attention heads when scaled up.
    """

    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel_size: int = 1


@dataclasses.dataclass(frozen=True)
class EmotiVoiceConfig:
    audio: AudioConfig = dataclasses.field(default_factory=AudioConfig)
    am: AcousticConfig = dataclasses.field(default_factory=AcousticConfig)
    vocoder: VocoderConfig = dataclasses.field(default_factory=VocoderConfig)
    disc: DiscriminatorConfig = dataclasses.field(
        default_factory=DiscriminatorConfig
    )
    bert: StyleBertConfig = dataclasses.field(default_factory=StyleBertConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def replace(self, **kw) -> "EmotiVoiceConfig":
        return dataclasses.replace(self, **kw)


def tiny_test_config() -> EmotiVoiceConfig:
    """A scaled-down config for fast unit tests / dryruns."""
    return EmotiVoiceConfig(
        am=AcousticConfig(
            n_vocab=32,
            n_speaker=8,
            hidden=16,
            bert_embedding=12,
            encoder_n_layers=1,
            encoder_n_heads=2,
            decoder_n_layers=1,
            decoder_n_heads=2,
            variance_n_hidden=16,
            variance_n_layers=2,
            n_mels=20,
            max_pe_len=512,
        ),
        vocoder=VocoderConfig(
            initial_channel=20,
            upsample_initial_channel=32,
            upsample_rates=(8, 8, 2, 2),
            upsample_kernel_sizes=(16, 16, 4, 4),
            resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 3, 5),),
        ),
        disc=DiscriminatorConfig(
            # 2 MPD periods + 1 (spectral-norm) MSD scale: every code path
            # (period reshape, grouped convs, power iteration) at ~1/1000
            # the parameter count of the full 8-tower discriminator.
            periods=(2, 3),
            period_channels=(4, 8, 8, 8),
            n_scales=1,
            scale_layers=(
                (8, 15, 1, 1, 7),
                (8, 41, 2, 4, 20),
                (8, 5, 1, 1, 2),
            ),
        ),
        bert=StyleBertConfig(
            vocab_size=64,
            hidden_size=12,
            num_layers=1,
            num_heads=2,
            intermediate_size=24,
            max_position_embeddings=64,
        ),
        train=TrainConfig(batch_size=2, segment_size=8),
    )
