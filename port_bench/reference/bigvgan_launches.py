"""The launches of the port's anti-aliased SnakeBeta kernel for the
BigVGAN-v2 generator of `bigvgan_v2.py`, which `readers.roofline` reads
through the configuration's key "launches": one launch per activation
(`bigvgan_v2.activations`, 109 at the published widths), each over the
whole bucket, and each launch's operations (`bigvgan_v2.act_flops`) and
bytes.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from port_bench.reference.bigvgan_v2 import TAPS, act_flops, activations, stages

KERNELS = {"aa_snake": "aa_snake_kernel"}


def kernel_launches(cfg: Dict, rows: int, frames: int,
                    dtype: str) -> Dict[str, List[Tuple[int, int]]]:
    """The (operations, bytes) of each aa_snake launch of one generator
    call over `rows` x `frames`: x read once and y written once in the
    compute dtype, alpha, beta and both filters' taps read once in f32."""
    item = 2 if dtype == "bf16" else 4
    length = {c: t for c, t in stages(cfg, frames)}
    return {"aa_snake": [(act_flops(c, rows * length[c]),
                          2 * item * rows * length[c] * c + 4 * (2 * c + 2 * TAPS))
                         for _, c in activations(cfg)]}
