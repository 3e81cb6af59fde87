"""The benchmark's weights: one state dict made on the device from the seed,
loaded into the program and handed as it is to the reference.

The configuration's reference module (`spec.reference`) gives every tensor's
shape (`param_shapes`) and how it is drawn (`init`: a scale and an offset of
N(0, 1)). Every tensor comes out of one `torch.randn` call on a generator
seeded with `--seed`, scaled in one multiply and offset in one add; the
module's `fixed`, where it has one, then sets what the draw leaves (for the
released model, weight-norm g = ||v||). Two departures, listed under
`assumed` in the configuration file:

- the duration predictor's output layer (`DURATION_OUT`) is scaled so that
  log durations spread by about `log_scale` (most of it shared by a
  request's tokens: its speaking rate), and biased so that their mean over
  the run's first requests (up to `CALIBRATION`) is `log_mean`, about 5
  frames a token (read speech at 62.5 frames a second). With N(0, 1 /
  fan_in) they come out near 1 frame a token and the buckets are nearly all
  padding; without the calibration the mean moves by some 15% from seed to
  seed, and the delivered audio with it;
- style and content embeddings are random unit-scale vectors drawn per
  request by the traffic generator (the SimBERT encoder is not run).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from port_bench.spec import reference

CALIBRATION = 1024  # requests the duration predictor's bias is calibrated on
CHUNK = 256


def make_state_dict(cfg: Dict, seed: int, device, reqs) -> Dict[str, torch.Tensor]:
    """The seeded f32 state dict, every tensor a view of one buffer; `reqs`
    (`traffic.Requests`) the run's requests, for the duration bias."""
    ref = reference(cfg)
    shapes = ref.param_shapes(cfg)
    dur = cfg["assumed"]["durations"]
    keys = list(shapes)
    sizes = [math.prod(shapes[k]) for k in keys]
    scale, offset = zip(*(ref.init(k, shapes[k], cfg) for k in keys))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    total = sum(sizes)
    counts = torch.tensor(sizes, device=device)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    flat.mul_(torch.repeat_interleave(torch.tensor(scale, device=device), counts, output_size=total))
    flat.add_(torch.repeat_interleave(torch.tensor(offset, device=device), counts, output_size=total))
    sd = {k: v.view(shapes[k]) for k, v in zip(keys, torch.split(flat, sizes))}
    if hasattr(ref, "fixed"):
        ref.fixed(sd, cfg)
    sd[f"{ref.DURATION_OUT}.bias"].fill_(dur["log_mean"] - mean_log_duration(sd, cfg, reqs, device))
    return sd


@torch.no_grad()
def mean_log_duration(sd, cfg: Dict, reqs, device) -> float:
    """Mean log duration over the tokens of the first requests (the
    reference's acoustic model, f32, padded chunks)."""
    ref = reference(cfg)
    total, count = 0.0, 0
    n = min(len(reqs), CALIBRATION)
    dev = lambda x, dt: torch.as_tensor(x, dtype=dt, device=device)  # noqa: E731
    with ref.Precision().flags():
        for lo in range(0, n, CHUNK):
            rows = range(lo, min(n, lo + CHUNK))
            lens = np.array([len(reqs.tokens[i]) for i in rows])
            tok = np.zeros((len(lens), int(lens.max())), np.int64)
            for j, i in enumerate(rows):
                tok[j, : lens[j]] = reqs.tokens[i]
            out = ref.acoustic(sd, cfg, dev(tok, torch.long), dev(lens, torch.long),
                               dev(reqs.speaker[lo:lo + len(lens)], torch.long),
                               dev(reqs.style[lo:lo + len(lens)], torch.float32),
                               dev(reqs.content[lo:lo + len(lens)], torch.float32), 16)
            total += float(out["log_d"].sum())  # zero past each request's end
            count += int(lens.sum())
    return total / count
