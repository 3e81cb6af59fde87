"""Subprocess worker of tests/test_torch_parallel.py (no tests of its own).

One process of a data-parallel run of the PyTorch port, on the CPU over
gloo. The rank and the group come from the torchrun environment (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT); without it the process is the one-
process reference. Modes:

  step   --out F.npz [--steps N] [--tp N]: N steps of the port's
         `TrainStep` on a seeded global batch of 4 rows (one padded shape,
         as the JAX package's global array), this rank's 2 (or all 4 in one
         process): rank 0 holds the long rows, rank 1 the short ones; with
         --tp the models are split over N CPU devices
         (`parallel.tensor_parallel`). Writes the metrics of every step, the
         segment starts, the mean gradients of step 1 and every parameter
         and buffer after step N, all in the one-device layout. Then, from
         fresh models, one step whose masked prosody means are each rank's
         own (the control that must miss), and its generator gradients.
  loader --out F.json: this rank's share of a datalist through a bucketed,
         prefetching loader for two epochs, agreed as the training loop
         agrees them, with one all-reduce per step; writes the steps taken,
         the padded widths of each step and the batches its loader alone
         yields.
"""

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from emotivoice_tpu_torch.config import tiny_test_config  # noqa: E402
from emotivoice_tpu_torch.parallel.data_parallel import DataParallel  # noqa: E402
from emotivoice_tpu_torch.parallel.multihost import (  # noqa: E402
    initialize_multihost,
    shard_datalist,
)

TEXT_LENGTHS = (8, 6, 5, 4)  # rank 0 holds the first two rows, rank 1 the last two
MEL_LENGTHS = (28, 23, 18, 15)


def train_config():
    """tiny_test_config with every dropout rate 0, two MSD scales, lr 1e-3
    (the port's side of tests/test_torch_support.train_configs)."""
    c = tiny_test_config()
    return c.replace(
        am=dataclasses.replace(c.am, encoder_p_dropout=0.0, decoder_p_dropout=0.0,
                               variance_p_dropout=0.0, duration_p_dropout=0.0,
                               variance_embed_p_dropout=0.0),
        disc=dataclasses.replace(c.disc, n_scales=2),
        train=dataclasses.replace(c.train, lr=1e-3))


def global_rows(cfg, seed: int):
    """The 4 rows of one global batch, each at its own length (numpy)."""
    rng = np.random.RandomState(seed)
    d, m = cfg.am.bert_embedding, cfg.am.n_mels
    rows = []
    for i, (nt, nf) in enumerate(zip(TEXT_LENGTHS, MEL_LENGTHS)):
        rows.append(dict(
            tokens=rng.randint(1, cfg.am.n_vocab, nt), speaker=i + 1,
            style_embedding=rng.randn(d), content_embedding=rng.randn(d),
            mel=rng.randn(nf, m), pitch=rng.randn(nf), energy=rng.randn(nf),
            wav=0.3 * rng.randn(nf * 256)))
    return rows


def collate(rows):
    """Rows padded with zeros to their longest text and mel, as tensors."""
    t_text = max(len(r["tokens"]) for r in rows)
    t_mel = max(len(r["mel"]) for r in rows)
    b, m = len(rows), rows[0]["mel"].shape[1]
    out = dict(tokens=np.zeros((b, t_text)), text_lengths=np.zeros(b), speaker=np.zeros(b),
               style_embedding=np.stack([r["style_embedding"] for r in rows]),
               content_embedding=np.stack([r["content_embedding"] for r in rows]),
               mel=np.zeros((b, t_mel, m)), mel_lengths=np.zeros(b), pitch=np.zeros((b, t_mel)),
               energy=np.zeros((b, t_mel)), wav=np.zeros((b, t_mel * 256)))
    for i, r in enumerate(rows):
        nt, nf = len(r["tokens"]), len(r["mel"])
        out["tokens"][i, :nt] = r["tokens"]
        out["text_lengths"][i], out["mel_lengths"][i] = nt, nf
        out["speaker"][i] = r["speaker"]
        for k in ("mel", "pitch", "energy"):
            out[k][i, :nf] = r[k]
        out["wav"][i, :nf * 256] = r["wav"]
    ints = ("tokens", "text_lengths", "speaker", "mel_lengths")
    return {k: torch.from_numpy(v).long() if k in ints else torch.from_numpy(v).float()
            for k, v in out.items()}


def fresh_trainer(cfg, dp, tp=1):
    from emotivoice_tpu_torch.parallel.tensor_parallel import tensor_parallel
    from emotivoice_tpu_torch.training.loop import build_models
    from emotivoice_tpu_torch.training.step import TrainStep

    torch.manual_seed(0)
    models = [tensor_parallel(m, ["cpu"] * tp) for m in build_models(cfg, torch.device("cpu"))]
    return TrainStep(cfg, *models, steps_per_epoch=1000, dp=dp)


def whole_grads(prefix, module):
    """{prefix.name: gradient} of every parameter with one, in the one-device
    layout (a split parameter's parts' gradients gathered)."""
    from emotivoice_tpu_torch.parallel.tensor_parallel import full_parameters

    out = {}
    for name, parts, dim in full_parameters(module):
        if parts[0].grad is not None:
            g = parts[0].grad if dim is None else torch.cat([p.grad for p in parts], dim)
            out[f"{prefix}.{name}"] = g.numpy().copy()
    return out


def run_steps(args, dp) -> None:
    cfg = train_config()
    trainer = fresh_trainer(cfg, dp, args.tp)
    starts = []
    draw = trainer.draw_starts
    trainer.draw_starts = lambda lengths: starts.append(draw(lengths)) or starts[-1]
    out = {}
    for step in range(args.steps):
        batch = dp.shard_batch(collate(global_rows(cfg, seed=100 + step)))
        metrics = trainer(batch)
        for k, v in metrics.items():
            out[f"metric/{step}/{k}"] = float(v)
        out[f"starts/{step}"] = starts[-1].numpy()
        if step == 0:
            grads = {**whole_grads("g", trainer.model), **whole_grads("d", trainer.disc)}
            out.update({f"grad/{k}": v for k, v in grads.items()})
    for prefix, module in (("g", trainer.model), ("d", trainer.disc)):
        for k, v in module.state_dict().items():
            out[f"param/{prefix}.{k}"] = v.numpy()

    # The control: each rank's masked means over its own tokens.
    trainer = fresh_trainer(cfg, dp, args.tp)
    trainer.token_count = lambda text_lengths: None
    trainer(dp.shard_batch(collate(global_rows(cfg, seed=100))))
    out.update({f"control_grad/{k}": v for k, v in whole_grads("g", trainer.model).items()})
    np.savez(args.out, **out)


class _Items:
    """A datalist of records with seeded lengths over several buckets."""

    def __init__(self, cfg, idx):
        self.cfg, self.idx = cfg, idx

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, i):
        rng = np.random.RandomState(self.idx[i])
        nt = int(rng.choice([20, 50, 90]))
        nf = int(rng.choice([200, 300]))
        d = self.cfg.am.bert_embedding
        return dict(tokens=np.ones(nt, np.int32), text_length=np.int32(nt),
                    speaker=np.int32(0), style_embedding=np.zeros(d, np.float32),
                    content_embedding=np.zeros(d, np.float32),
                    mel=np.zeros((nf, 4), np.float32), mel_length=np.int32(nf),
                    pitch=np.zeros(nf, np.float32), energy=np.zeros(nf, np.float32),
                    wav=np.zeros(nf * self.cfg.audio.hop_length, np.float32))


def run_loader(args, dp) -> None:
    from emotivoice_tpu_torch.data.dataset import BucketedLoader, PrefetchLoader
    from emotivoice_tpu_torch.training.loop import batch_widths, pad_batch

    cfg = tiny_test_config()
    items = _Items(cfg, shard_datalist(list(range(36)), dp.rank, dp.world))
    alone = [sum(1 for _ in BucketedLoader(items, 2, seed=7 + e)) for e in range(2)]
    steps, widths = [], []
    for epoch in range(2):
        n = 0
        loader = PrefetchLoader(BucketedLoader(items, 2, seed=7 + epoch))
        for batch in dp.agreed(loader, batch_widths, pad_batch):
            dp.all_reduce_sum(torch.ones(1))  # what a step's gradient all-reduce waits on
            widths.append([*batch_widths(batch), batch["wav"].shape[1], batch["pitch"].shape[1]])
            n += 1
        steps.append(n)
    with open(args.out, "w") as f:
        json.dump({"rank": dp.rank, "steps": steps, "alone": alone, "widths": widths}, f)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["step", "loader"])
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--tp", type=int, default=1, help="model group size (CPU devices)")
    args = ap.parse_args()
    torch.set_num_threads(1)
    rank, world = initialize_multihost("cpu", timeout_s=240)
    dp = DataParallel(rank, world)
    try:
        (run_steps if args.mode == "step" else run_loader)(args, dp)
    finally:
        if world > 1:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
