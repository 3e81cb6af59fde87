"""The launches of the port's two MRF kernels for the HiFi-GAN V1 generator
of `model.py`, which `readers.roofline` reads through the configuration's
key "launches": which kernel serves which MRF stage, by the program's
dispatch rule (its `hifigan.FUSED_UNIT_MIN_CHANNELS`), and each launch's
operations and bytes. The rule is the program's, kept out of the reference
forward that decides `correct`; the operations are the model's
(`model.stages`, `model.mrf_unit_flops`).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from port_bench.reference.model import mrf_unit_flops, stages

# A residual-unit launch per unit where the stage has at least this many
# channels, one whole-stage launch below.
UNIT_MIN_CHANNELS = 128
KERNELS = {"resblock": "residual_unit_kernel", "mrf_stage": "mrf_stage_kernel"}


def kernel_launches(cfg: Dict, rows: int, frames: int, dtype: str) -> Dict[str, List[Tuple[int, int]]]:
    """The (operations, bytes) of each MRF kernel launch of one generator
    call over `rows` x `frames`, by the key of `KERNELS`: x read once and y
    written once, each weight and bias read once."""
    v = cfg["vocoder"]
    item = 2 if dtype == "bf16" else 4
    out: Dict[str, List[Tuple[int, int]]] = {"resblock": [], "mrf_stage": []}
    for c, t in stages(cfg, frames):
        units = [(k, d) for k, ds in zip(v["resblock_kernel_sizes"], v["resblock_dilation_sizes"])
                 for d in ds]
        act = 2 * rows * t * c
        if c >= UNIT_MIN_CHANNELS:
            for k, _ in units:
                out["resblock"].append((mrf_unit_flops(c, t, k, rows),
                                        item * (act + 2 * k * c * c + 2 * c)))
        else:
            out["mrf_stage"].append((sum(mrf_unit_flops(c, t, k, rows) for k, _ in units),
                                     item * (act + sum(2 * k * c * c + 2 * c for k, _ in units))))
    return out
