"""Training loop: checkpoints, resume, warm start, validation, logging
(counterpart of `emotivoice_tpu/training/loop.py`; reference
`train_am_vocoder_joint.py:198-460`).

Checkpoints are `torch.save` files in the reference's layout, in
`<output_dir>/ckpt`:
  - ``g_{step:08d}``: {"generator": JETSGenerator state dict, "iteration"};
  - ``do_{step:08d}``: {"discriminator": state dict (spectral-norm u, v
    included), "optim_g", "optim_d", "iteration", "segment_rng", "rng"}:
    the two Adam states, the segment generator's state and torch's global
    RNG states (dropout), which the JAX package's Orbax state also restores.
The newest complete pair is resumed; `max_to_keep` pairs are kept. One
process drives one device. Over several processes (`dp`, one rank each)
every rank restores and steps on its own rows, and only rank 0 logs,
validates and writes checkpoints. With models split over the ranks of
model groups (`tensor_parallel.RankGroup`, `dp` the data group of the
mesh) the ranks of the first data index (model group 0) validate and
gather the checkpoints' state together, and the world's rank 0 alone
writes. The JAX loop's validation pass before the first step is not
ported: it exists there to compile the eval shapes.
"""

from __future__ import annotations

import os
import re
import time
from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from emotivoice_tpu_torch.config import EmotiVoiceConfig
from emotivoice_tpu_torch.models.discriminator import Discriminator
from emotivoice_tpu_torch.models.jets import JETSGenerator, init_random_
from emotivoice_tpu_torch.parallel.data_parallel import DataParallel
from emotivoice_tpu_torch.training.step import TrainStep, learning_rate
from emotivoice_tpu_torch.utils.device import resolve_device, resolve_dtype, use_exact_f32

_INT_KEYS = ("tokens", "text_lengths", "speaker", "mel_lengths")


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A collated numpy batch as tensors on `device` (ids and lengths int64)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        out[k] = (t.long() if k in _INT_KEYS else t.float()).to(device)
    return out


def batch_widths(batch: Dict[str, np.ndarray]) -> Tuple[int, int]:
    """(text, mel) padded widths of a collated batch."""
    return batch["tokens"].shape[1], batch["mel"].shape[1]


def pad_batch(batch: Dict[str, np.ndarray], widths) -> Dict[str, np.ndarray]:
    """A collated batch zero-padded to wider (text, mel) widths; the
    waveform to mel width x hop."""
    t_text, t_mel = widths
    hop = batch["wav"].shape[1] // batch["mel"].shape[1]
    width = {"tokens": t_text, "mel": t_mel, "pitch": t_mel, "energy": t_mel,
             "wav": t_mel * hop}
    out = dict(batch)
    for k, w in width.items():
        v = np.asarray(batch[k])
        pad = [(0, 0)] * v.ndim
        pad[1] = (0, w - v.shape[1])
        out[k] = np.pad(v, pad)
    return out


class CheckpointManager:
    """g_/do_ pairs in one directory: save, rotate, find and load the newest."""

    _NAME = re.compile(r"^(g|do)_(\d{8})$")

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, kind: str, step: int) -> str:
        return os.path.join(self.directory, f"{kind}_{step:08d}")

    def steps(self):
        """Steps with both files present, oldest first."""
        found: Dict[int, set] = {}
        for name in os.listdir(self.directory):
            m = self._NAME.match(name)
            if m:
                found.setdefault(int(m.group(2)), set()).add(m.group(1))
        return sorted(s for s, kinds in found.items() if kinds == {"g", "do"})

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, trainer: TrainStep, write: bool = True) -> None:
        """The trainer's pair at its step, in the one-device layout. Models
        split over the ranks of a model group gather their state, so every
        rank of the group calls this, and only one passes `write`."""
        step = trainer.count
        rng = {"torch": torch.get_rng_state()}
        dev = trainer.segment_generator.device
        if dev.type == "cuda":
            rng["cuda"] = torch.cuda.get_rng_state(dev)
        g = {"generator": trainer.model.state_dict(), "iteration": step}
        do = {"discriminator": trainer.disc.state_dict(), **trainer.state_dict(), "rng": rng}
        if not write:
            return
        torch.save(g, self._path("g", step))
        torch.save(do, self._path("do", step))
        for old in self.steps()[:-self.max_to_keep]:
            for kind in ("g", "do"):
                os.remove(self._path(kind, old))

    def restore(self, trainer: TrainStep) -> Optional[int]:
        """Load the newest pair into the trainer's models, optimizers and
        RNGs; its step, or None when there is none."""
        step = self.latest_step()
        if step is None:
            return None
        g = torch.load(self._path("g", step), map_location="cpu", weights_only=True)
        do = torch.load(self._path("do", step), map_location="cpu", weights_only=True)
        trainer.model.load_state_dict(g["generator"])
        trainer.disc.load_state_dict(do["discriminator"])
        trainer.load_state_dict(do)
        torch.set_rng_state(do["rng"]["torch"])
        dev = trainer.segment_generator.device
        if dev.type == "cuda" and "cuda" in do["rng"]:
            torch.cuda.set_rng_state(do["rng"]["cuda"], dev)
        return step


class MetricLogger:
    """Append-only text log, and tensorboard when it is installed (reference
    rank-0 logging, train_am_vocoder_joint.py:27-32,423-430)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.text_path = os.path.join(log_dir, "train_log.txt")
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(log_dir)
        except ImportError:
            self.tb = None

    def log(self, step: int, metrics: dict, prefix: str = "train") -> None:
        # .6g keeps small values significant (lr 1.25e-5 shows its decay)
        line = f"step={step} " + " ".join(
            f"{k}={float(v):.6g}" for k, v in sorted(metrics.items()))
        with open(self.text_path, "a") as f:
            f.write(line + "\n")
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(f"{prefix}/{k}", float(v), step)


def build_models(cfg: EmotiVoiceConfig, device: torch.device,
                 dtype: Union[str, torch.dtype] = torch.float32):
    """The trainer's generator (kernels=False) and discriminator (computing
    in `dtype`), random parameters from cfg.train.seed (smoke mode, or
    before a warm start)."""
    seed = cfg.train.seed
    model = init_random_(JETSGenerator(cfg, kernels=False), seed).to(device)
    disc = init_random_(Discriminator(cfg.disc, resolve_dtype(dtype)), seed + 1).to(device)
    return model, disc


def train(
    cfg: EmotiVoiceConfig,
    batch_iter_fn: Callable[[], Iterable[dict]],
    output_dir: str,
    total_steps: int,
    steps_per_epoch: int = 1000,
    validate_fn: Optional[Callable[[int], None]] = None,
    valid_batch_iter_fn: Optional[Callable[[], Iterable[dict]]] = None,
    warm_start_fn: Optional[Callable[[TrainStep], None]] = None,
    log_every: int = 50,
    device: Optional[Union[str, torch.device]] = None,
    models: Optional[Tuple[torch.nn.Module, torch.nn.Module]] = None,
    dtype: Union[str, torch.dtype] = torch.float32,
    dp: Optional[DataParallel] = None,
) -> TrainStep:
    """Run joint AM + vocoder GAN training on `device` (None: the card).

    batch_iter_fn: a fresh epoch iterator of collated numpy batches.
    valid_batch_iter_fn: the same over the held-out set; without an explicit
      validate_fn it wires `make_validate_fn` (every iters_per_validation).
    warm_start_fn(trainer): applied when no checkpoint exists (the
      reference's --load_pretrained_model).
    models: (generator built with kernels=False, discriminator) on `device`
      to train; default `build_models(cfg, device, dtype)`.
    dtype: the compute dtype of the train steps and of validation (f32
      turns TF32 off: `use_exact_f32`).
    dp: this process's rank of a data-parallel group; default the
      initialised process group's, else one rank. `batch_iter_fn` then
      yields this rank's batches; every rank runs the same number of
      steps per epoch, each step's batches padded to one shape
      (`DataParallel.agreed`). Over a (data, model) mesh of ranks, `dp` is
      the rank's data group (`DataParallel.from_mesh`), `models` are split
      over its model group (`tensor_parallel.RankGroup`), and the ranks of
      a model group are given the same batches.
    Returns the TrainStep (models, optimizers, update count)."""
    device = resolve_device(device)
    use_exact_f32(dtype)
    dp = dp if dp is not None else DataParallel.from_process_group(device)
    main = dp.is_main()  # over a (data, model) mesh: every rank of model group 0
    world_rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    writer = main and world_rank == 0
    torch.manual_seed(cfg.train.seed)  # the same dropout stream on every rank
    logger = MetricLogger(os.path.join(output_dir, "log")) if writer else None
    ckpts = CheckpointManager(os.path.join(output_dir, "ckpt"))
    model, disc = models if models is not None else build_models(cfg, device, dtype)
    trainer = TrainStep(cfg, model, disc, steps_per_epoch, dtype, dp)
    restored = ckpts.restore(trainer)
    if restored is not None:
        if writer:
            print(f"resumed from step {restored}", flush=True)
    elif warm_start_fn is not None:
        warm_start_fn(trainer)
        if writer:
            print("warm-started from pretrained checkpoint", flush=True)

    if main and validate_fn is None and valid_batch_iter_fn is not None:
        from emotivoice_tpu_torch.training.validate import make_validate_fn

        validate_fn = make_validate_fn(
            cfg, model, lambda: (to_device(b, device) for b in valid_batch_iter_fn()), logger,
            dtype=trainer.dtype)

    model.train()
    disc.train()
    t = cfg.train
    t_start, t_paused = time.time(), 0.0  # validation / checkpoint time is left out of s/s
    while trainer.count < total_steps:
        seen = False
        for batch in dp.agreed(batch_iter_fn(), batch_widths, pad_batch):
            seen = True
            metrics = trainer(to_device(batch, device))
            step = trainer.count
            if writer and step % log_every == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                metrics["lr"] = learning_rate(cfg, step, steps_per_epoch)
                metrics["epoch"] = step // steps_per_epoch
                metrics["steps_per_sec"] = log_every / max(time.time() - t_start - t_paused, 1e-6)
                t_start, t_paused = time.time(), 0.0
                logger.log(step, metrics)
            if main and validate_fn is not None and step % t.iters_per_validation == 0:
                t0 = time.time()
                validate_fn(step)
                t_paused += time.time() - t0
            if main and step % t.iters_per_checkpoint == 0:
                t0 = time.time()
                ckpts.save(trainer, write=writer)
                t_paused += time.time() - t0
            if step >= total_steps:
                break
        if not seen:
            raise ValueError("the training loader yielded no batch (fewer utterances "
                             "than one batch per bucket?)")
    if main:
        ckpts.save(trainer, write=writer)
    return trainer
