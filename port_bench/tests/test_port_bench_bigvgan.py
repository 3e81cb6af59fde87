"""The configuration `bigvgan-v2-bf16` and its yardstick: its file names its
modules and they keep the contract; the published generator's parameters;
the filters' taps; the clamp on a seeded request; the activation kernel's
launches; a whole run at a tiny BigVGAN on the CPU, sound and with the
activations' channels mixed; on the card, the control fails on three seeds."""

import io
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import as_file, few_requests
from port_bench import harness, spec, weights
from port_bench.reference import bigvgan_launches, bigvgan_v2

CELL = "bigvgan-bf16-bulk"
PUBLISHED_PARAMETERS = 112_199_472  # weight norm folded (one weight a conv), as upstream counts


def _config():
    return json.load(open(os.path.join(spec.HERE, "configs", "bigvgan-v2-bf16.json")))


def _tiny_file():
    from emotivoice_tpu_torch.config import VocoderConfig, tiny_test_config
    cfg = tiny_test_config().replace(vocoder=VocoderConfig(
        activation="snakebeta", initial_channel=20, upsample_initial_channel=32,
        upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4), use_tanh_at_final=False,
        use_bias_at_final=False))
    f = as_file(cfg)
    f.update(reference="bigvgan_v2.py", launches="bigvgan_launches.py")
    f["assumed"]["vocoder_init"] = {"snake_log_std": 0.5, "amp_conv_gain": 0.5,
                                    "conv_post_gain": 0.2}
    return f


def test_the_configuration_names_its_modules_by_contract():
    cell = spec.load_cell(CELL)
    assert cell.config["name"] == "bigvgan-v2-bf16" and cell.chips == 1
    assert spec.reference(cell.config) is bigvgan_v2
    assert spec.launches(cell.config) is bigvgan_launches
    for key, names in spec.CONTRACT.items():
        mod = spec.named_module(cell.config, key)
        assert all(callable(getattr(mod, n)) or isinstance(getattr(mod, n), (str, dict))
                   for n in names)
    assert callable(bigvgan_v2.fixed)
    bench = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
    entry = next(c for c in bench["configs"] if c["name"] == "bigvgan-v2-bf16")
    assert entry["reduced"] == []
    assert {m["name"] for m in cell.per_layer} >= {"aa_snake_roofline.bulk", "aa_snake_share.bulk",
                                                   "mfu.bulk", "vocoder_ms_per_audio_s.bulk"}
    assert not {m["name"] for m in cell.per_layer} & {"resblock_roofline.bulk",
                                                      "mrf_stage_roofline.bulk"}


def test_published_generator_has_112_m_parameters():
    cfg = _config()
    shapes = bigvgan_v2.param_shapes(cfg)
    gen = {k: s for k, s in shapes.items() if k.startswith("generator.")}
    learned = sum(math.prod(s) for k, s in gen.items()
                  if not k.endswith(("weight_g", ".filter")))
    assert learned == PUBLISHED_PARAMETERS
    v = cfg["vocoder"]
    assert [v["upsample_initial_channel"] // 2 ** (i + 1) for i in range(6)] == [768, 384, 192,
                                                                                 96, 48, 24]
    assert len(bigvgan_v2.activations(cfg)) == 109
    assert "generator.conv_post.bias" not in shapes


def test_fixed_sets_the_kaiser_taps():
    """`fixed` writes into every filter buffer the taps of the formula, here
    computed again with numpy: symmetric, summing to 1."""
    cfg = _tiny_file()
    shapes = bigvgan_v2.param_shapes(cfg)
    sd = {k: torch.zeros(s) for k, s in shapes.items()}
    bigvgan_v2.fixed(sd, cfg)
    half, cutoff, half_width = 6, 0.25, 0.3
    atten = 2.285 * (half - 1) * math.pi * 4 * half_width + 7.95
    assert atten > 50.0
    t = np.arange(-half, half) + 0.5
    f = 2 * cutoff * np.kaiser(12, 0.1102 * (atten - 8.7)) * np.sinc(2 * cutoff * t)
    f /= f.sum()
    filters = [k for k in sd if k.endswith(".filter")]
    assert len(filters) == 2 * len(bigvgan_v2.activations(cfg))
    for k in filters:
        taps = sd[k].flatten().double().numpy()
        assert np.allclose(taps, f, rtol=0, atol=1e-7)
        assert np.array_equal(taps, taps[::-1]) and abs(taps.sum() - 1) < 1e-6


def test_few_samples_reach_the_clamp_on_a_seeded_request():
    """The published widths on the CPU, the seeded draw with its duration
    calibration: a 24-token request's waveform, under 1% of samples at
    +-1, and not silent."""
    cfg = _config()
    reqs = few_requests(cfg, n=8, seed=7)
    sd = weights.make_state_dict(cfg, 2 ** 31 + 7, "cpu", reqs)
    n = 24
    tok = torch.as_tensor(reqs.tokens[0][:n][None], dtype=torch.long)
    out = bigvgan_v2.synthesize(sd, cfg, tok, torch.tensor([n]),
                                torch.as_tensor(reqs.speaker[:1], dtype=torch.long),
                                torch.as_tensor(reqs.style[:1]), torch.as_tensor(reqs.content[:1]),
                                192)
    frames = int(out["n_frames"][0])
    wav = out["wav"][0, : frames * 256]
    assert 40 <= frames < 192
    assert float((wav.abs() >= 1.0).float().mean()) < 0.01
    assert float(wav.abs().mean()) > 0.01


def test_one_launch_per_activation_with_its_bytes():
    cfg = _config()
    for rows, frames, dtype in ((16, 2048, "bf16"), (3, 768, "f32")):
        launches = bigvgan_launches.kernel_launches(cfg, rows, frames, dtype)
        assert set(launches) == set(bigvgan_launches.KERNELS) == {"aa_snake"}
        got = launches["aa_snake"]
        assert len(got) == 109
        item = 2 if dtype == "bf16" else 4
        per_frame = {768: 4, 384: 16, 192: 32, 96: 64, 48: 128, 24: 256}  # rates 4 4 2 2 2 2
        want_bytes = 0
        for _, c in bigvgan_v2.activations(cfg):
            t = frames * per_frame[c]
            want_bytes += 2 * item * rows * t * c + 4 * (2 * c + 24)
        assert sum(b for _, b in got) == want_bytes
        assert sum(f for f, _ in got) == 58 * 614_400 * rows * frames
    # 16 x 2048 in bf16: 80.5 GB, at least 24 ms at 3.35 TB/s
    total = sum(b for _, b in bigvgan_launches.kernel_launches(cfg, 16, 2048, "bf16")["aa_snake"])
    assert 80.4e9 < total < 80.6e9


def _tiny_cell():
    cell = spec.load_cell(CELL)
    cell.config = dict(_tiny_file(), dtype="f32")
    tok = dict(cell.traffic["tokens"], median=12, min=4, max=40)
    cell.traffic = dict(cell.traffic, lines=96, batch=4, block_batches=3, tokens=tok,
                        check_every=1, check_sample=1000)
    return cell


def _execute(cell):
    return harness.execute(cell, 2 ** 31 + 23, 1.0, False, time.perf_counter(), device="cpu",
                           err=io.StringIO())


def test_whole_run_on_the_cpu_at_a_tiny_bigvgan():
    res = _execute(_tiny_cell())
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"audio_s_per_s", "setup_s"}


def test_mixed_channels_are_not_correct(monkeypatch):
    """An activation that takes each channel's alpha and beta from the next
    channel (a kernel that mixes channels) fails the check."""
    from emotivoice_tpu_torch.models import bigvgan

    orig = bigvgan.Activation1d.forward

    def forward(self, x):
        a, b = self.act.alpha.data.clone(), self.act.beta.data.clone()
        self.act.alpha.data, self.act.beta.data = a.roll(1), b.roll(1)
        try:
            return orig(self, x)
        finally:
            self.act.alpha.data, self.act.beta.data = a, b

    monkeypatch.setattr(bigvgan.Activation1d, "forward", forward)
    res = _execute(_tiny_cell())
    assert res["correct"] is False


@pytest.mark.card
def test_control_fails_on_three_seeds_at_the_cells_size(card):
    """The fp8 control at the cell's own size comes out not correct on three
    seeds, and fails on the waveform's number: the vocoder's check alone
    would catch it. The program comes out correct."""
    for seed in (2 ** 31 + 111, 2 ** 31 + 112, 2 ** 31 + 113):
        out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", CELL, "--seed",
                              str(seed), "--seconds", "4", "--trace", "0", "--control", "1"],
                             cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"] is True
        ctrl = res["control"]
        assert ctrl["correct"] is False
        assert ctrl["numbers"]["wav_err"] > res["checked"]["wav_err"]["limit"]
