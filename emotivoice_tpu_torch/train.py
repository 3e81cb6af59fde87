"""Joint acoustic-model + HiFi-GAN training CLI of the port (counterpart of
`tools/train_joint.py`; reference `train_am_vocoder_joint.py`):

  python -m emotivoice_tpu_torch.train --datalist DIR/datalist.jsonl \\
      --valid-datalist DIR/valid.jsonl --tokenlist DIR/tokenlist \\
      --speakers DIR/speakers --output-dir OUT [--device cpu] [--total-steps N]

Runs on the card unless `--device cpu` is given. Without `--style-encoder`
the style and content embeddings are zeros (smoke mode). Warm start from
reference `g_*` / `do_*` checkpoints, voice cloning by growing the speaker
table (`--new-speakers`). The JAX tool's `--jax-cache` does not exist here.

Data parallel over several processes, one rank each, with `--multihost`:

  torchrun --nproc-per-node 2 -m emotivoice_tpu_torch.train --multihost ...

(or RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT set by hand).
Each rank loads its share of the datalist (`shard_datalist`), and
`--batch-size` is the global batch: each rank takes batch-size // world
rows. A rank drives `cuda:LOCAL_RANK` unless `--device` names a device;
there must be a card for each local rank. The backend is NCCL on cards and
gloo on the CPU unless `--backend` names one: two ranks that share one card
(`--device cuda:0`) need `--backend gloo`.
"""

from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--datalist", required=True)
    p.add_argument("--valid-datalist", default=None,
                   help="held-out datalist; enables validation every --iters-per-validation steps")
    p.add_argument("--iters-per-validation", type=int, default=1000)
    p.add_argument("--iters-per-checkpoint", type=int, default=None,
                   help="checkpoint period (default from TrainConfig)")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--tokenlist", default=None)
    p.add_argument("--speakers", default=None)
    p.add_argument("--style-encoder", default=None)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--pretrained-generator", default=None,
                   help="reference g_XXXXXXXX checkpoint to warm-start from")
    p.add_argument("--pretrained-discriminator", default=None,
                   help="reference do_XXXXXXXX checkpoint to warm-start from")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--total-steps", type=int, default=140000)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--cache-dir", default=None)
    p.add_argument("--new-speakers", type=int, default=0,
                   help="grow the speaker table by N rows (voice cloning)")
    p.add_argument("--device", default=None,
                   help="cuda (default; cuda:LOCAL_RANK with --multihost) or cpu")
    p.add_argument("--seed", type=int, default=None, help="TrainConfig.seed (parameters, draws)")
    p.add_argument("--smoke-tiny", action="store_true",
                   help="tiny_test_config model, for smoke runs")
    p.add_argument("--multihost", action="store_true",
                   help="one data-parallel rank per process (torchrun environment); "
                        "--batch-size is the global batch")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                   help="process-group backend with --multihost (default: nccl on cards, "
                        "gloo on the CPU)")
    args = p.parse_args(argv)
    if args.backend and not args.multihost:
        p.error("--backend needs --multihost")

    import torch

    from emotivoice_tpu_torch.parallel.multihost import initialize_multihost, local_rank
    from emotivoice_tpu_torch.utils.device import resolve_device

    rank, world = 0, 1
    if args.multihost:
        device = resolve_device(args.device or f"cuda:{local_rank()}")
        if device.type == "cuda":
            if args.device is None and local_rank() >= torch.cuda.device_count():
                raise RuntimeError(
                    f"LOCAL_RANK {local_rank()} needs card {local_rank()} but "
                    f"{torch.cuda.device_count()} are visible; start fewer ranks per host "
                    "or name a device with --device")
            torch.cuda.set_device(device)
        rank, world = initialize_multihost(device, args.backend)
        print(f"multihost: rank {rank} of {world} on {device}", flush=True)
    else:
        device = resolve_device(args.device)
    try:
        _train(args, device, rank, world)
    finally:
        if world > 1:
            torch.distributed.destroy_process_group()


def _train(args, device, rank: int, world: int) -> None:
    import numpy as np
    import torch

    from emotivoice_tpu_torch.config import EmotiVoiceConfig, tiny_test_config
    from emotivoice_tpu_torch.convert.from_reference import (
        load_checkpoint,
        load_discriminator,
        load_jets_generator,
    )
    from emotivoice_tpu_torch.data.dataset import BucketedLoader, PrefetchLoader, PromptTTSDataset
    from emotivoice_tpu_torch.frontend.tokens import load_label_list
    from emotivoice_tpu_torch.models.jets import JETSGenerator
    from emotivoice_tpu_torch.parallel.multihost import shard_datalist
    from emotivoice_tpu_torch.serving.loading import build_embed_fn, config_and_vocab
    from emotivoice_tpu_torch.training.loop import train

    cfg = EmotiVoiceConfig()
    if args.smoke_tiny:  # the features' mel width follows the tiny model's
        cfg = tiny_test_config()
        cfg = cfg.replace(audio=dataclasses.replace(cfg.audio, n_mels=cfg.am.n_mels))
    cfg, vocab = config_and_vocab(cfg, args.tokenlist)
    speakers = (load_label_list(args.speakers) if args.speakers
                else [str(i) for i in range(cfg.am.n_speaker)])
    train_kw = {"batch_size": args.batch_size, "iters_per_validation": args.iters_per_validation}
    if args.iters_per_checkpoint:
        train_kw["iters_per_checkpoint"] = args.iters_per_checkpoint
    if args.seed is not None:
        train_kw["seed"] = args.seed
    base_cfg = cfg.replace(am=dataclasses.replace(cfg.am, n_speaker=len(speakers)))
    cfg = cfg.replace(am=dataclasses.replace(cfg.am, n_speaker=len(speakers) + args.new_speakers),
                      train=dataclasses.replace(cfg.train, **train_kw))

    embed_fn = build_embed_fn(cfg, args.style_encoder, args.tokenizer, device)
    dataset = PromptTTSDataset(args.datalist, cfg, vocab, speakers, embed_fn,
                               cache_dir=args.cache_dir, device=device)
    # an epoch is the whole datalist at the global batch (the JAX tool
    # divides the rank's share by the global batch instead)
    steps_per_epoch = max(len(dataset) // args.batch_size, 1)
    dataset.utts = shard_datalist(dataset.utts, rank, world)
    local_bs = max(args.batch_size // world, 1)
    loader = lambda: PrefetchLoader(BucketedLoader(dataset, local_bs))  # noqa: E731
    valid_loader = None
    if args.valid_datalist and rank == 0:  # rank 0 validates
        valid_dataset = PromptTTSDataset(args.valid_datalist, cfg, vocab, speakers, embed_fn,
                                         cache_dir=args.cache_dir, device=device)
        valid_loader = lambda: BucketedLoader(  # noqa: E731
            valid_dataset, local_bs, shuffle=False, drop_last=False, pad_to_batch=True)

    warm_start_fn = None
    if args.pretrained_generator:
        def warm_start_fn(trainer):
            # reference prepare_for_training.py:91-97: grow the speaker
            # table for cloning, then warm-start
            base = load_jets_generator(JETSGenerator(base_cfg, kernels=False),
                                       load_checkpoint(args.pretrained_generator))
            sd = base.state_dict()
            if args.new_speakers:
                emb = sd["am.spk_tokenizer.weight"]
                rows = np.random.RandomState(0).randn(args.new_speakers, emb.shape[1])
                sd["am.spk_tokenizer.weight"] = torch.cat(
                    [emb, torch.from_numpy(rows.astype(np.float32))])
            trainer.model.load_state_dict(sd)
            if args.pretrained_discriminator:
                load_discriminator(trainer.disc, load_checkpoint(args.pretrained_discriminator))

    train(cfg, loader, args.output_dir, total_steps=args.total_steps,
          steps_per_epoch=steps_per_epoch, valid_batch_iter_fn=valid_loader,
          warm_start_fn=warm_start_fn, log_every=args.log_every, device=device)


if __name__ == "__main__":
    main()
