"""Validation: held-out losses, a mel comparison figure and a sample wav
(counterpart of `emotivoice_tpu/training/validate.py`; reference
`validate()`, `train_am_vocoder_joint.py:57-195`).

The eval step runs under `torch.inference_mode()` with `cut=False` (the
whole decoded mel is vocoded) and with the generator's kernels switched on,
so validation launches both MRF kernels on the card: 18 + 2 per generator
call at the V1 topology. A model split over the ranks of a model group
validates on every rank of the group (each runs both kernels on the
gathered whole weights); only the rank given a logger writes.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Callable, Dict, Iterable

import numpy as np
import torch

from emotivoice_tpu_torch.training.losses import prosody_losses
from emotivoice_tpu_torch.utils.audio_io import write_wav
from emotivoice_tpu_torch.utils.masks import sequence_mask


def plot_mel_comparison(gt_mel: np.ndarray, pred_mel: np.ndarray):
    """(T, n_mels) pair -> matplotlib figure (reference plot_image.py)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 1, figsize=(10, 6))
    for ax, mel, title in ((axes[0], gt_mel, "ground truth"), (axes[1], pred_mel, "predicted")):
        im = ax.imshow(mel.T, origin="lower", aspect="auto", interpolation="none")
        ax.set_title(title)
        fig.colorbar(im, ax=ax)
    fig.tight_layout()
    return fig


def eval_step(model, batch: Dict[str, torch.Tensor], dtype: torch.dtype = torch.float32):
    """Validation losses, decoded mel and waveform of one batch in compute
    `dtype` (on the batch's device, no host sync)."""
    with torch.inference_mode():
        out = model(
            batch["tokens"], batch["text_lengths"], batch["speaker"],
            batch["style_embedding"], batch["content_embedding"],
            mel_targets=batch["mel"], feats_lengths=batch["mel_lengths"],
            pitch_targets=batch["pitch"], energy_targets=batch["energy"], cut=False,
            dtype=dtype,
        )
        mel = batch["mel"]
        valid = sequence_mask(batch["mel_lengths"], mel.shape[1]).float()
        mel_l1 = torch.sum(torch.abs(out["dec_outputs"] - mel) * valid[..., None]) / torch.clamp(
            valid.sum() * mel.shape[-1], min=1.0)
        metrics = {"mel_l1": mel_l1, **prosody_losses(out), "bin_loss": out["bin_loss"]}
    return metrics, out["dec_outputs"], out["wav_predictions"]


def make_validate_fn(cfg, model, valid_batches: Callable[[], Iterable[Dict[str, torch.Tensor]]],
                     logger, max_batches: int = 8, dtype: torch.dtype = torch.float32):
    """validate(step): mean losses over at most `max_batches` batches of
    `valid_batches()` (tensors on the model's device, computed in `dtype`:
    in bf16 both kernels run in bf16), logged with prefix
    "valid"; the first item's wav written beside the text log; the audio to
    tensorboard when the logger has it, the mel figure too when matplotlib
    is installed. With `logger` None the pass runs and nothing is written
    (a rank of a model group that does not write); it returns the mean
    losses either way."""

    def validate(step: int) -> Dict[str, float]:
        gen = model.generator
        kernels, training = gen.kernels, model.training
        gen.kernels = True
        model.eval()
        try:
            agg: Dict[str, float] = {}
            n, sample = 0, None
            for batch in valid_batches():
                metrics, pred_mel, wav = eval_step(model, batch, dtype)
                for k, v in metrics.items():
                    agg[k] = agg.get(k, 0.0) + float(v)
                if sample is None:
                    ml = int(batch["mel_lengths"][0])
                    sample = (batch["mel"][0, :ml].cpu().numpy(),
                              pred_mel[0, :ml].float().cpu().numpy(), wav[0].cpu().numpy())
                n += 1
                if n >= max_batches:
                    break
        finally:
            gen.kernels = kernels
            model.train(training)
        means = {k: v / n for k, v in agg.items()}
        if n == 0 or logger is None:
            return means
        logger.log(step, means, prefix="valid")
        gt, pred, wav = sample
        write_wav(os.path.join(os.path.dirname(logger.text_path), f"valid_audio_{step:08d}.wav"),
                  np.clip(wav.astype(np.float32), -1.0, 1.0), cfg.audio.sampling_rate)
        if logger.tb is not None:
            if importlib.util.find_spec("matplotlib") is not None:
                logger.tb.add_figure("valid/mel_comparison", plot_mel_comparison(gt, pred), step)
            logger.tb.add_audio("valid/audio_predicted", wav[None, :], step,
                                sample_rate=cfg.audio.sampling_rate)
        return means

    return validate
