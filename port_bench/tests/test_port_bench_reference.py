"""The benchmark's plain reference against the program's model, on the CPU
at the tiny test configuration: one seeded state dict in both, durations,
frame counts, mel and waveform held together. (The test may import the
program; the reference may not.)"""

import numpy as np
import pytest
import torch

from port_bench.reference.model import param_shapes, synthesize
from port_bench.weights import make_state_dict
from conftest import few_requests


@pytest.mark.parametrize("t_text,max_frames,n_tok", [(16, 128, 11), (32, 192, 32)])
def test_reference_matches_program_model(tiny_file, t_text, max_frames, n_tok):
    from emotivoice_tpu_torch.config import tiny_test_config
    from emotivoice_tpu_torch.models.jets import JETSGenerator

    cfg = tiny_file
    sd = make_state_dict(cfg, 2 ** 31 + 77, "cpu", few_requests(cfg))
    model = JETSGenerator(tiny_test_config()).eval()
    model.load_state_dict(sd, strict=True)
    rng = np.random.default_rng(5)
    tokens = torch.zeros(1, t_text, dtype=torch.long)
    tokens[0, :n_tok] = torch.as_tensor(rng.integers(1, cfg["am"]["n_vocab"], n_tok))
    length = torch.tensor([n_tok])
    speaker = torch.tensor([3])
    e = cfg["am"]["bert_embedding"]
    style, content = (torch.as_tensor(rng.standard_normal((1, e)), dtype=torch.float32)
                      for _ in range(2))
    with torch.inference_mode():
        got = model(tokens, length, speaker, style, content, max_frames=max_frames)
    want = synthesize(sd, cfg, tokens, length, speaker, style, content, max_frames)
    assert torch.equal(got["durations"], want["durations"])
    assert int(got["output_lengths"][0]) == int(want["n_frames"][0]) > n_tok
    nf = int(want["n_frames"][0])
    torch.testing.assert_close(got["log_duration_predictions"], want["log_d"], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got["dec_outputs"][:, :nf], want["mel"][:, :nf], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got["wav_predictions"], want["wav"], rtol=1e-4, atol=1e-6)
    assert want["wav"].abs().max() > 0


def test_param_shapes_cover_the_program_state_dict(tiny_file):
    from emotivoice_tpu_torch.config import EmotiVoiceConfig, tiny_test_config
    from emotivoice_tpu_torch.models.jets import JETSGenerator
    from conftest import as_file

    for c in (tiny_test_config(), EmotiVoiceConfig()):
        have = {k: tuple(v.shape) for k, v in JETSGenerator(c).state_dict().items()}
        assert param_shapes(as_file(c)) == have


def test_weights_deterministic_in_seed(tiny_file):
    a = make_state_dict(tiny_file, 2 ** 33 + 1, "cpu", few_requests(tiny_file))
    b = make_state_dict(tiny_file, 2 ** 33 + 1, "cpu", few_requests(tiny_file))
    c = make_state_dict(tiny_file, 2 ** 33 + 2, "cpu", few_requests(tiny_file))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["am.to_mel.weight"], c["am.to_mel.weight"])
    from port_bench.weights import mean_log_duration
    mean = tiny_file["assumed"]["durations"]["log_mean"]
    assert mean_log_duration(a, tiny_file, few_requests(tiny_file), "cpu") == pytest.approx(mean, abs=1e-5)


def test_control_precisions_read_further_from_f32(tiny_file):
    """The lower precisions the control runs in are further from f32 than
    f32 itself (on the CPU TF32 is not used, so only fp8 moves)."""
    sd = make_state_dict(tiny_file, 11, "cpu", few_requests(tiny_file))
    tokens = torch.randint(1, 32, (1, 16), generator=torch.Generator().manual_seed(0))
    args = (tokens, torch.tensor([16]), torch.tensor([1]), torch.ones(1, 12), -torch.ones(1, 12), 256)
    ref = synthesize(sd, tiny_file, *args)
    low = synthesize(sd, tiny_file, *args, durations=ref["durations"], precision="fp8")
    err = (low["wav"] - ref["wav"]).norm() / ref["wav"].norm()
    assert 1e-3 < float(err) < 1.0
