"""Joint acoustic-model + HiFi-GAN training CLI of the port (counterpart of
`tools/train_joint.py`; reference `train_am_vocoder_joint.py`):

  python -m emotivoice_tpu_torch.train --datalist DIR/datalist.jsonl \\
      --valid-datalist DIR/valid.jsonl --tokenlist DIR/tokenlist \\
      --speakers DIR/speakers --output-dir OUT [--device cpu] [--total-steps N]

Runs on the card unless `--device cpu` is given. Without `--style-encoder`
the style and content embeddings are zeros (smoke mode). Warm start from
reference `g_*` / `do_*` checkpoints, voice cloning by growing the speaker
table (`--new-speakers`). One process, one device: the JAX tool's
`--multihost` and `--jax-cache` do not exist here (argparse refuses them).
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
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=None, help="TrainConfig.seed (parameters, draws)")
    p.add_argument("--smoke-tiny", action="store_true",
                   help="tiny_test_config model, for smoke runs")
    args = p.parse_args(argv)

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
    from emotivoice_tpu_torch.serving.loading import build_embed_fn, config_and_vocab
    from emotivoice_tpu_torch.training.loop import train
    from emotivoice_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
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
    loader = lambda: PrefetchLoader(BucketedLoader(dataset, args.batch_size))  # noqa: E731
    valid_loader = None
    if args.valid_datalist:
        valid_dataset = PromptTTSDataset(args.valid_datalist, cfg, vocab, speakers, embed_fn,
                                         cache_dir=args.cache_dir, device=device)
        valid_loader = lambda: BucketedLoader(  # noqa: E731
            valid_dataset, args.batch_size, shuffle=False, drop_last=False, pad_to_batch=True)

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
          steps_per_epoch=max(len(dataset) // args.batch_size, 1),
          valid_batch_iter_fn=valid_loader, warm_start_fn=warm_start_fn,
          log_every=args.log_every, device=device)


if __name__ == "__main__":
    main()
