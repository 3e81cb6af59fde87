"""OpenAI-compatible TTS server of the PyTorch port (counterpart of
`tools/serve.py`).

  python -m emotivoice_tpu_torch.serve [--checkpoint <g_ckpt>] \
      [--style-encoder <checkpoint_163431> --tokenizer <simbert vocab dir>] \
      [--device cuda|cpu] [--port 8000]

Runs on FastAPI when uvicorn is installed, else on the stdlib HTTP server.
POST /v1/audio/speech with {"input", "voice", "prompt", "response_format",
"speed", "stream"}. Without --checkpoint the parameters are random, made
from `--seed`; without --style-encoder the embeddings are zero (smoke mode).

`--data-parallel N` holds one replica of the model on each of cuda:0 ..
cuda:N-1 (N CPU replicas with `--device cpu`) and splits every batch over
them; fewer cards than N is an error. `--multihost` runs one server per
process, as the JAX server does: each joins the process group of the
torchrun environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT), holds a full replica on cuda:LOCAL_RANK (or `--device`) and
answers on its own `--port`, behind a load balancer; requests never cross
processes. The model-parallel mode of the JAX server is a later slice.
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", default=None, help="reference g_* generator checkpoint")
    p.add_argument("--dtype", choices=["f32", "bf16"], default="f32",
                   help="compute dtype (parameters stay f32)")
    p.add_argument("--style-encoder", default=None, help="reference style-encoder checkpoint")
    p.add_argument("--tokenizer", default=None, help="simbert tokenizer path")
    p.add_argument("--tokenlist", default=None)
    p.add_argument("--speakers", default=None, help="speaker list file")
    p.add_argument("--lexicon", default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--no-warmup", action="store_true",
                   help="skip running the common bucket shapes at startup")
    p.add_argument("--no-background-warmup", action="store_true",
                   help="skip warming the remaining bucket grid in a "
                        "background thread after startup")
    p.add_argument("--blocking-warmup", action="store_true",
                   help="finish the full bucket-grid warmup BEFORE listening "
                        "(slower start; the first request of any shape is "
                        "then warm)")
    p.add_argument("--no-batching", action="store_true",
                   help="disable cross-request micro-batching")
    p.add_argument("--smoke-tiny", action="store_true",
                   help="tiny_test_config model (random parameters), for smoke tests")
    p.add_argument("--device", default=None,
                   help="cuda (default; cuda:LOCAL_RANK with --multihost) or cpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data-parallel", type=int, default=0,
                   help="replicas on cuda:0..N-1 (N CPU replicas with --device cpu); "
                        "0 = one device")
    p.add_argument("--multihost", action="store_true",
                   help="join the torchrun process group; one server per process, each "
                        "with a full replica, behind a load balancer")
    args = p.parse_args(argv)
    if args.data_parallel > 1 and args.multihost:
        p.error("--data-parallel and --multihost: one server per process holds one replica")
    if args.data_parallel > 1 and args.device and torch.device(args.device).index is not None:
        p.error("--data-parallel places its replicas on cuda:0..N-1; name no card index")

    from emotivoice_tpu_torch.config import EmotiVoiceConfig, tiny_test_config
    from emotivoice_tpu_torch.frontend.en import read_lexicon
    from emotivoice_tpu_torch.frontend.mixed import g2p_cn_en
    from emotivoice_tpu_torch.frontend.tokens import load_label_list
    from emotivoice_tpu_torch.serving.api import TTSService, serve_stdlib
    from emotivoice_tpu_torch.serving.engine import SynthesisEngine
    from emotivoice_tpu_torch.serving.loading import (
        build_embed_fn,
        build_generator,
        config_and_vocab,
    )
    from emotivoice_tpu_torch.utils.device import resolve_device, use_exact_f32

    devices = None
    if args.multihost:
        from emotivoice_tpu_torch.parallel.multihost import initialize_multihost, local_rank

        device = resolve_device(args.device or f"cuda:{local_rank()}")
        if device.type == "cuda" and (device.index or 0) >= torch.cuda.device_count():
            raise RuntimeError(f"{device} does not exist: {torch.cuda.device_count()} "
                               "card(s) are visible")
        rank, world = initialize_multihost(device)
        print(f"multihost: process {rank} of {world} on {device}", flush=True)
    else:
        device = resolve_device(args.device)  # raises before any work without a card
    if args.data_parallel > 1:
        n = args.data_parallel
        if device.type == "cuda" and torch.cuda.device_count() < n:
            raise RuntimeError(f"--data-parallel {n} needs {n} cards; "
                               f"{torch.cuda.device_count()} are visible")
        devices = [torch.device(device.type, i) if device.type == "cuda" else device
                   for i in range(n)]
    use_exact_f32(args.dtype)
    cfg, vocab = config_and_vocab(
        tiny_test_config() if args.smoke_tiny else EmotiVoiceConfig(), args.tokenlist)
    speakers = (load_label_list(args.speakers) if args.speakers
                else [str(i) for i in range(cfg.am.n_speaker)])
    lexicon = read_lexicon(args.lexicon) if args.lexicon else None

    model = build_generator(cfg, args.checkpoint, args.seed)
    engine = SynthesisEngine(cfg, model, vocab, dtype=args.dtype,
                             device=None if devices else device, devices=devices)
    embed_fn = build_embed_fn(cfg, args.style_encoder, args.tokenizer, device)

    if not args.no_warmup:
        print("running common bucket shapes once...", flush=True)
        engine.warmup()
        print("warmup done", flush=True)
    if not args.no_background_warmup:
        # Warm the rest of the production bucket grid on a daemon thread
        # that yields to live traffic; --blocking-warmup joins it before
        # listening instead.
        th = engine.warmup_background(
            progress_cb=lambda i, n: print(f"background warmup {i}/{n}", flush=True)
            if i == n or i % 10 == 0 else None
        )
        if args.blocking_warmup:
            print("blocking on full grid warmup...", flush=True)
            th.join()
            print(f"grid warmup done ({engine.warmup_failures} shapes failed)", flush=True)
    service = TTSService(
        engine,
        g2p_fn=lambda text: g2p_cn_en(text, lexicon),
        embed_fn=embed_fn,
        speaker2id={s: i for i, s in enumerate(speakers)},
        batching=not args.no_batching,
    )

    try:
        import uvicorn
    except ImportError:
        print(f"fastapi/uvicorn unavailable; stdlib server on {args.host}:{args.port}",
              flush=True)
        serve_stdlib(service, args.host, args.port)
    else:
        from emotivoice_tpu_torch.serving.api import create_fastapi_app

        uvicorn.run(create_fastapi_app(service), host=args.host, port=args.port)


if __name__ == "__main__":
    main()
