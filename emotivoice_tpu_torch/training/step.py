"""The joint acoustic-model + vocoder GAN training step (counterpart of
`emotivoice_tpu/training/step.py`; reference
`train_am_vocoder_joint.py:315-420`).

One step, in the reference's order:
  1. one generator forward with autograd (alignment search, random
     `segment_size`-frame crop, vocoder on the crop);
  2. D step: the real segment and the detached fake through the
     discriminator with `update_stats=True` (spectral-norm power
     iteration), LSGAN D loss, Adam update of D;
  3. G step against the *updated* D (`update_stats=False`, D's parameters
     frozen for it): segment mel L1 x45, duration / pitch / energy L1,
     forward-sum x2, bin x2, LSGAN adversarial, feature matching; backward
     through the forward of 1, Adam update of G.
The JAX step runs two structurally identical forwards and lets XLA merge
them; here the one forward's graph is kept.

Two Adams (lr 1.25e-5, betas (0.5, 0.9), eps 1e-9), each update at
lr * gamma ** (count // steps_per_epoch) with `count` the updates made
before it, as optax evaluates its schedule. The generator is built with
`kernels=False`, since the MRF kernels have no backward.

`dtype` bf16 runs the generator's and the discriminator's compute in bf16
(JAX `init_train_state(compute_dtype=)`): the parameters, Adam's moments
and every loss stay f32, with no loss scaling (LSGAN outputs are O(1)).

Over several ranks (`dp`), the step computes the global batch's function,
as the JAX step partitioned over a mesh does: each rank runs its rows, and
after each backward the gradients are averaged over the ranks by hand
(DistributedDataParallel would expect a gradient for every parameter after
each forward, which the G step's frozen-D pass does not give). The terms
that are not per-row means, the masked prosody means, divide by the global
batch's valid-token count; the segment starts are drawn for the global
batch from the shared seeded generator. Spectral-norm u, v follow D's
weights only, so they stay equal on every rank.

The models may be tensor-parallel (`parallel.tensor_parallel`; the JAX
`make_parallel_train_step(state=...)` over a 'model' axis), over a model
group of devices in this process or over the ranks of a model group, one
shard per process (`RankGroup`; then `dp` is the rank's data group of the
(data, model) mesh, `mesh.make_rank_mesh` / `DataParallel.from_mesh`, and
every rank of a model group calls the step on the same rows). The
optimizers then hold the parameters' parts, which is exact for Adam
(elementwise), and a parameter held whole gets its whole gradient from
autograd through the collectives (over ranks: on every rank of the group),
so no gradient needs a reduction across shards; over ranks the copies of
a whole parameter's gradient are averaged over the group
(`mean_replicated_grads`), which keeps the ranks' copies equal where a
card's backward rounds differently on each. `state_dict()` gathers
Adam's moments into the one-device layout, as the models' own state dicts
do (over ranks, every rank of the group calls it), so a checkpoint resumes
in either layout.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from emotivoice_tpu_torch.config import EmotiVoiceConfig
from emotivoice_tpu_torch.models.discriminator import (
    discriminator_loss,
    feature_loss,
    generator_loss,
)
from emotivoice_tpu_torch.ops.mel import mel_spectrogram
from emotivoice_tpu_torch.ops.segments import get_segments, random_starts
from emotivoice_tpu_torch.parallel.data_parallel import DataParallel
from emotivoice_tpu_torch.parallel.tensor_parallel import (
    load_optimizer_state_dict,
    mean_replicated_grads,
    optimizer_state_dict,
)
from emotivoice_tpu_torch.training.losses import (
    alignment_losses,
    prosody_losses,
    segment_mel_l1,
)
from emotivoice_tpu_torch.utils.device import resolve_dtype

Batch = Dict[str, torch.Tensor]


def learning_rate(cfg: EmotiVoiceConfig, count: int, steps_per_epoch: int) -> float:
    """lr of the update that follows `count` earlier ones (per-epoch
    exponential decay, reference ExponentialLR gamma=0.999875)."""
    t = cfg.train
    return t.lr * t.lr_gamma_per_epoch ** (count // steps_per_epoch)


def make_optimizer(cfg: EmotiVoiceConfig, params) -> torch.optim.Adam:
    t = cfg.train
    if t.weight_decay:
        raise ValueError(
            f"TrainConfig.weight_decay={t.weight_decay}: the JAX step's optax.adam has no "
            "weight-decay term, so the port's Adam takes none either")
    return torch.optim.Adam(params, lr=t.lr, betas=t.betas, eps=t.eps)


class TrainStep:
    """Holds the two optimizers, the update count and the generator of the
    segment draws; `__call__(batch)` runs one step on this rank's rows and
    returns the global batch's metrics as detached scalars on the device
    (no host sync on one rank)."""

    def __init__(self, cfg: EmotiVoiceConfig, model: nn.Module, disc: nn.Module,
                 steps_per_epoch: int = 1000, dtype: Union[str, torch.dtype] = torch.float32,
                 dp: Optional[DataParallel] = None):
        if model.generator.kernels:
            raise ValueError("train a generator built with kernels=False: the MRF "
                             "kernels have no backward")
        self.cfg, self.model, self.disc = cfg, model, disc
        self.steps_per_epoch = steps_per_epoch
        self.dtype = resolve_dtype(dtype)
        device = next(model.parameters()).device
        self.dp = dp if dp is not None else DataParallel(device=device)
        self.dp.broadcast_module(model)
        self.dp.broadcast_module(disc)
        self.opt_g = make_optimizer(cfg, model.parameters())
        self.opt_d = make_optimizer(cfg, disc.parameters())
        self.count = 0
        self.segment_generator = torch.Generator(device=device).manual_seed(cfg.train.seed)

    def seg_mel(self, wav: torch.Tensor) -> torch.Tensor:
        a = self.cfg.audio
        m = mel_spectrogram(wav, a.sampling_rate, a.n_fft, a.hop_length, a.win_length,
                            a.n_mels, a.fmin, a.fmax, loss_mode=True)
        return m.transpose(-1, -2)  # (B, frames, n_mels)

    def draw_starts(self, mel_lengths: torch.Tensor) -> torch.Tensor:
        """Segment start frames of this rank's rows, drawn for the global
        batch (every rank draws the same uniforms and keeps its own)."""
        b, world = mel_lengths.shape[0], self.dp.world
        return random_starts(mel_lengths, self.cfg.train.segment_size, self.segment_generator,
                             rows=self.dp.local_rows(b * world), n_draw=b * world)

    def token_count(self, text_lengths: torch.Tensor) -> Optional[torch.Tensor]:
        """The denominator of this rank's masked prosody means: the global
        batch's valid-token count over the number of ranks, so that the
        mean of the ranks' gradients is the global masked mean's (a mean of
        per-rank means is not, when ranks hold different lengths). None on
        one rank: the batch's own count."""
        if self.dp.world == 1:
            return None
        n = self.dp.all_reduce_sum(text_lengths.sum().float())
        return torch.clamp(n, min=1.0) / self.dp.world

    def generator_forward(self, batch: Batch,
                          start_idxs: Optional[torch.Tensor] = None) -> Tuple[dict, torch.Tensor]:
        """The generator's forward with autograd, and the real segment.
        `start_idxs` replays given segment starts instead of drawing them."""
        if start_idxs is None:
            start_idxs = self.draw_starts(batch["mel_lengths"])
        out = self.model(
            batch["tokens"], batch["text_lengths"], batch["speaker"],
            batch["style_embedding"], batch["content_embedding"],
            mel_targets=batch["mel"], feats_lengths=batch["mel_lengths"],
            pitch_targets=batch["pitch"], energy_targets=batch["energy"],
            dtype=self.dtype, start_idxs=start_idxs,
        )
        up = self.cfg.vocoder.upsample_factor
        y = get_segments(batch["wav"], out["z_start_idxs"].long() * up,
                         self.cfg.train.segment_size * up)
        return out, y

    def _update(self, opt: torch.optim.Optimizer) -> None:
        lr = learning_rate(self.cfg, self.count, self.steps_per_epoch)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()

    def discriminator_step(self, y: torch.Tensor, y_hat: torch.Tensor) -> torch.Tensor:
        self.opt_d.zero_grad(set_to_none=True)
        real, fake, _, _ = self.disc(y, y_hat.detach(), update_stats=True)
        d_loss = discriminator_loss(real, fake)
        d_loss.backward()
        mean_replicated_grads(self.disc)
        self.dp.mean_grads(self.disc.parameters())
        self._update(self.opt_d)
        return d_loss.detach()

    def generator_step(self, out: dict, y: torch.Tensor) -> Dict[str, torch.Tensor]:
        t = self.cfg.train
        self.opt_g.zero_grad(set_to_none=True)
        self.disc.requires_grad_(False)
        try:
            y_hat = out["wav_predictions"]
            _, fake, real_fmaps, fake_fmaps = self.disc(y, y_hat, update_stats=False)
            mel_loss = segment_mel_l1(self.seg_mel(y_hat), self.seg_mel(y))
            pros = prosody_losses(out, self.token_count(out["input_lengths"]))
            align = alignment_losses(out)
            adv = generator_loss(fake)
            fm = feature_loss(real_fmaps, fake_fmaps)
            total = (
                t.w_mel * mel_loss
                + t.w_dur * pros["dur_loss"]
                + t.w_pitch * pros["pitch_loss"]
                + t.w_energy * pros["energy_loss"]
                + t.w_forwardsum * align["forwardsum_loss"]
                + t.w_bin * align["bin_loss"]
                + t.w_adv * adv
                + t.w_fm * fm
            )
            total.backward()
        finally:
            self.disc.requires_grad_(True)
        mean_replicated_grads(self.model)
        self.dp.mean_grads(self.model.parameters())
        self._update(self.opt_g)
        metrics = {"mel_loss": mel_loss, "adv_loss": adv, "fm_loss": fm, **pros, **align,
                   "g_loss": total}
        return {k: v.detach() for k, v in metrics.items()}

    def __call__(self, batch: Batch, start_idxs: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
        out, y = self.generator_forward(batch, start_idxs)
        d_loss = self.discriminator_step(y, out["wav_predictions"])
        metrics = self.generator_step(out, y)
        self.count += 1
        metrics["d_loss"] = d_loss
        return self.dp.mean_metrics(metrics)

    def state_dict(self) -> dict:
        """Optimizers (in the one-device layout), update count and the
        segment generator's state."""
        return {"optim_g": optimizer_state_dict(self.opt_g, self.model),
                "optim_d": optimizer_state_dict(self.opt_d, self.disc),
                "iteration": self.count, "segment_rng": self.segment_generator.get_state()}

    def load_state_dict(self, state: dict) -> None:
        load_optimizer_state_dict(self.opt_g, self.model, state["optim_g"])
        load_optimizer_state_dict(self.opt_d, self.disc, state["optim_d"])
        self.count = int(state["iteration"])
        if "segment_rng" in state:
            self.segment_generator.set_state(state["segment_rng"].cpu())
