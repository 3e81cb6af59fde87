"""The frozen work counters of the released model (`request_flops` of its
reference module, `kernel_launches` of its launch list) and the peaks of
`work.py`: the model count against torch's FlopCounterMode on the
reference, and the MRF kernels' bound at the bench bucket (16 rows x 384
frames) against the figures of the port's kernel table (PERF.md): 2.462 /
1.231 ms in bf16, 14.759 / 7.380 ms in f32."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import work
from port_bench.reference import hifigan_launches, model
from port_bench.weights import make_state_dict
from conftest import few_requests


def _config(name):
    from conftest import as_file
    from emotivoice_tpu_torch.config import EmotiVoiceConfig, tiny_test_config
    return as_file(tiny_test_config() if name == "tiny" else EmotiVoiceConfig())


@pytest.mark.parametrize("name,n_tok,n_frames", [("tiny", 13, 70), ("tiny", 40, 9), ("full", 7, 3)])
def test_request_flops_match_flop_counter(name, n_tok, n_frames):
    cfg = _config(name)
    sd = make_state_dict(cfg, 3, "cpu", few_requests(cfg, 4))
    e = cfg["am"]["bert_embedding"]
    tokens = torch.randint(1, cfg["am"]["n_vocab"], (1, n_tok), generator=torch.Generator().manual_seed(1))
    durations = torch.zeros(1, n_tok)
    durations[0, : n_frames % n_tok or n_tok] = 1.0
    durations[0, 0] += n_frames - float(durations.sum())
    with FlopCounterMode(display=False) as fc:
        out = model.synthesize(sd, cfg, tokens, torch.tensor([n_tok]), torch.tensor([0]), torch.zeros(1, e),
                         torch.zeros(1, e), n_frames, durations=durations)
    assert int(out["n_frames"][0]) == n_frames
    assert model.request_flops(cfg, n_tok, n_frames) == fc.get_total_flops()


def test_vocoder_flops_per_frame_full_width():
    cfg = _config("full")
    launches = hifigan_launches.kernel_launches(cfg, 1, 1, "bf16")
    mrf = sum(f for k in ("resblock", "mrf_stage") for f, _ in launches[k])
    assert mrf == 594_542_592  # 252 x T x C^2 summed over the four stages
    assert 613e6 < model.vocoder_flops(cfg, 1) < 615e6


@pytest.mark.parametrize("dtype,resblock_ms,stage_ms", [("bf16", 2.462, 1.231), ("f32", 14.759, 7.380)])
def test_mrf_bound_at_bench_bucket(dtype, resblock_ms, stage_ms):
    cfg = _config("full")
    launches = hifigan_launches.kernel_launches(cfg, 16, 384, dtype)
    assert (len(launches["resblock"]), len(launches["mrf_stage"])) == (18, 2)
    got = {k: 1e3 * sum(work.bound_seconds(f, b, dtype) for f, b in v) for k, v in launches.items()}
    assert got["resblock"] == pytest.approx(resblock_ms, abs=5e-4)
    assert got["mrf_stage"] == pytest.approx(stage_ms, abs=5e-4)
    for k in got:  # the 4 k C^2 B T rule, summed
        rule = sum(4 * kk * c * c * 16 * t * len(ds) for c, t in model.stages(cfg, 384)
                   if (c >= hifigan_launches.UNIT_MIN_CHANNELS) == (k == "resblock")
                   for kk, ds in zip(cfg["vocoder"]["resblock_kernel_sizes"],
                                     cfg["vocoder"]["resblock_dilation_sizes"]))
        assert sum(f for f, _ in launches[k]) == rule
