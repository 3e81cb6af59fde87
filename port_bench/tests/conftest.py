"""Shared set-up of the benchmark's tests: the repository root on the path,
the `card` marker (tests that need an NVIDIA card skip without one, deciding
inside the test), and a tiny configuration in the configuration file's
form."""

import dataclasses
import json
import math
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


def as_file(cfg, dtype: str = "f32") -> dict:
    """A program configuration in the benchmark's configuration-file form."""
    d = lambda x: json.loads(json.dumps(dataclasses.asdict(x)))  # noqa: E731
    return {"reference": "model.py", "launches": "hifigan_launches.py", "dtype": dtype,
            "control": "tf32" if dtype == "f32" else "fp8",
            "audio": d(cfg.audio), "am": d(cfg.am), "vocoder": d(cfg.vocoder),
            "assumed": {"durations": {"log_mean": math.log(6.0) - 0.15 ** 2 / 2,
                                      "log_scale": 0.15}}}


def few_requests(cfg: dict, n: int = 16, seed: int = 0):
    """A handful of seeded requests (the duration bias is calibrated on them)."""
    from port_bench import traffic
    mix = {"loop": "closed", "batch": 4, "lines": n, "block_batches": 2, "alpha": 1.0,
           "tokens": {"dist": "lognormal", "median": 12, "sigma": 0.5, "min": 4, "max": 40}}
    return traffic.generate(mix, cfg, seed, 1.0)


@pytest.fixture
def tiny_file():
    from emotivoice_tpu_torch.config import tiny_test_config
    return as_file(tiny_test_config())


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card by the command in port_bench/README.md")
