"""The yardstick is what the configuration names: for the released model,
the same readings as the harness gave before it looked its modules up by
name; a run that names another reference module is judged by that module; a
bad name fails by name.

The readings before the lookup by name were taken from that tree (its
`weights.make_state_dict`, `work.request_flops`, `work.mrf_launches` and
`reference.model.synthesize`) on the CPU with torch 2.13, one thread.
Integer results are held exactly (`request_flops`, the launch lists, the
frame counts). Float results (each tensor of the seeded state dict, the
reference's outputs) are held by `_summary` in `released_model_readings.json`
to a relative 1e-5 (state dict) and 1e-4 (outputs): the CPU's vector width
and the thread count move their last bits. Over one to eight threads and the
AVX-512, AVX2 and scalar kernels of that build they moved by at most 1.2e-7
and 1.1e-6 of those scales; a change of the model moves them by 1e-2 or
more."""

import hashlib
import importlib.util
import io
import json
import os
import sys
import time

import pytest
import torch

from conftest import as_file, few_requests
from port_bench import harness, spec

HERE = os.path.dirname(os.path.abspath(__file__))
READINGS = json.load(open(os.path.join(HERE, "released_model_readings.json")))
SEED = READINGS["seed"]
NAMES = ("tiny", "emotivoice-bf16", "emotivoice-f32")
FLOP_POINTS = [(1, 1), (17, 3), (64, 320), (256, 2048)]  # (tokens, frames)
FULL_FLOPS = [688218624, 2640611328, 210397544448, 1362532171776]
REQUEST_FLOPS = {"tiny": [462784, 1772800, 148850688, 1190240256],
                 "emotivoice-bf16": FULL_FLOPS, "emotivoice-f32": FULL_FLOPS}
LAUNCH_POINTS = [(16, 384, "bf16"), (16, 2048, "f32"), (1, 768, "bf16"), (3, 96, "f32")]  # rows, frames
FULL_LAUNCHES = ["2dd316f4e550c214d3fc8c640204632aed7ef4f5b66ec620accc81c3428f66a3",
                 "706bd9c2b83b3bcdd770ebaf74347ce98182765455453db534fa7d2741bf90a6",
                 "7d2e821dae7a1faf8b954aecb4d64c131fd503873dd0d14219f624c1983b4ab7",
                 "3c41862784ed43b5606c958bc19ede9e7d8fd0b0667dc936d4a9d31b6efeadeb"]
KERNEL_LAUNCHES = {
    "tiny": ["12697511bb6a364bde440590449979da5c41c8abe7044d3d180a987fa414e558",
             "0407922233288cbce11f8efef18ee75f425a3646da429c4ba1914e49ea4740f4",
             "37767cef809f4453a8afc7456e33997a5cb0889dd84929814c3e104812de95bd",
             "c02bb214132478fe1a0f39cd74cdd8663a03e3fb2f30c5b926d8a3e881df227b"],
    "emotivoice-bf16": FULL_LAUNCHES, "emotivoice-f32": FULL_LAUNCHES,
}


def _summary(t: torch.Tensor):
    """sum, sum of |t|, max |t|, and the values at eight evenly spaced places."""
    t = t.detach().double().flatten()
    idx = torch.linspace(0, t.numel() - 1, 8).round().long()
    return [float(t.sum()), float(t.abs().sum()), float(t.abs().max())] + [float(v) for v in t[idx]]


def _worst(got, want) -> float:
    """The largest gap of `got`'s summary from `want`'s: sums as a share of
    the sum of |t|, the rest as a share of max |t| (0 for a tensor of 0s)."""
    scale = want[1:2] * 2 + want[2:3] * (len(want) - 2)
    return max(abs(g - w) / s if s else (0.0 if g == w else float("inf"))
               for g, w, s in zip(got, want, scale))


def _config(name):
    from emotivoice_tpu_torch.config import tiny_test_config
    if name == "tiny":
        return as_file(tiny_test_config())
    return json.load(open(os.path.join(spec.HERE, "configs", name + ".json")))


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("name", NAMES)
def test_state_dict_identical_to_parent(one_thread, name):
    from port_bench.weights import make_state_dict
    cfg = _config(name)
    want = READINGS["state_dict"]["tiny" if name == "tiny" else "emotivoice"]
    sd = make_state_dict(cfg, SEED, "cpu", few_requests(cfg))
    assert list(sd) == list(want)
    worst = {k: _worst(_summary(v)[:2], want[k]) for k, v in sd.items()}
    assert max(worst.values()) <= 1e-5, {k: w for k, w in worst.items() if w > 1e-5}


@pytest.mark.parametrize("name", NAMES)
def test_work_counts_identical_to_parent(name):
    cfg = _config(name)
    ref, mod = spec.reference(cfg), spec.launches(cfg)
    assert [ref.request_flops(cfg, t, f) for t, f in FLOP_POINTS] == REQUEST_FLOPS[name]
    got = [hashlib.sha256(json.dumps(mod.kernel_launches(cfg, r, f, d), sort_keys=True).encode())
           .hexdigest() for r, f, d in LAUNCH_POINTS]
    assert got == KERNEL_LAUNCHES[name]
    assert mod.KERNELS == {"resblock": "residual_unit_kernel", "mrf_stage": "mrf_stage_kernel"}


@pytest.mark.parametrize("precision", ["f32", "fp8"])
def test_synthesize_identical_to_parent(one_thread, precision):
    from port_bench.weights import make_state_dict
    cfg = _config("tiny")
    sd = make_state_dict(cfg, SEED, "cpu", few_requests(cfg))
    g = torch.Generator().manual_seed(7)
    e = cfg["am"]["bert_embedding"]
    tokens = torch.zeros(1, 32, dtype=torch.long)
    tokens[0, :23] = torch.randint(1, cfg["am"]["n_vocab"], (23,), generator=g)
    style, content = torch.randn(1, e, generator=g), torch.randn(1, e, generator=g)
    out = spec.reference(cfg).synthesize(sd, cfg, tokens, torch.tensor([23]), torch.tensor([3]),
                                         style, content, 256, precision=precision)
    want = READINGS["synthesize"][precision]
    assert sorted(out) == sorted(want)
    assert out["n_frames"].tolist() == want["n_frames"]
    worst = {k: _worst(_summary(out[k]), want[k]) for k in want if k != "n_frames"}
    assert max(worst.values()) <= 1e-4, worst


def _tiny_bulk(tiny_file, reference):
    cell = spec.load_cell("bf16-bulk")
    cell.config = dict(tiny_file, dtype="f32", reference=reference)
    tok = dict(cell.traffic["tokens"], median=12, min=4, max=40)
    cell.traffic = dict(cell.traffic, lines=64, batch=4, block_batches=2, tokens=tok, check_every=1,
                        check_sample=1000)
    return cell


@pytest.mark.parametrize("reference,correct", [("model.py", True), ("last_activation.py", False)])
def test_run_is_judged_by_the_named_module(tiny_file, monkeypatch, reference, correct):
    """A whole traced run on the CPU: the weights come from the named module's
    `param_shapes` and `init`, `mfu` from its `request_flops`, and the check
    from its `synthesize`; the program computes the released model, so the
    run that names the test's variant comes out not correct."""
    cell = _tiny_bulk(tiny_file, reference)
    if reference != "model.py":
        name = "port_bench.reference." + reference[:-3]
        found = importlib.util.spec_from_file_location(name, os.path.join(HERE, "references", reference))
        module = importlib.util.module_from_spec(found)
        monkeypatch.setitem(sys.modules, name, module)  # as if the file were in port_bench/reference/
        found.loader.exec_module(module)
    ref = spec.reference(cell.config)
    counts = getattr(ref, "calls", None)
    res = harness.execute(cell, 2 ** 31 + 33, 1.0, True, time.perf_counter(), device="cpu",
                          err=io.StringIO())
    assert res["correct"] is correct and res["failed"] == 0
    assert res["metrics"]["mfu.bulk"]["value"] > 0
    if counts is not None:
        n_keys = len(ref.param_shapes(cell.config))
        assert counts["init"] == n_keys and counts["synthesize"] > 0
        assert counts["request_flops"] == res["attempted"]
        checked = {k: v["value"] <= v["limit"] for k, v in res["checked"].items()}
        assert checked == dict.fromkeys(checked, True) | {"wav_err": False}  # the vocoder's tail alone


RELEASED = {"reference": "model.py", "launches": "hifigan_launches.py"}


@pytest.mark.parametrize("key,value,error,named", [
    ("reference", None, KeyError, '"reference"'),
    ("launches", None, KeyError, '"launches"'),
    ("reference", "no_such_model.py", FileNotFoundError, "port_bench/reference/no_such_model.py"),
    ("launches", "no_such_list.py", FileNotFoundError, "port_bench/reference/no_such_list.py"),
    ("reference", "../check.py", ValueError, "'../check.py'"),
    ("launches", "hifigan_launches", ValueError, "'hifigan_launches'"),
    ("reference", "buckets.py", AttributeError, "port_bench/reference/buckets.py"),
    ("launches", "model.py", AttributeError, "port_bench/reference/model.py"),
])
def test_bad_reference_fails_by_name(tiny_file, key, value, error, named):
    """A missing key, a name that is not a bare .py file, a missing file and
    a module without the key's contract each fail with the key or the path
    in the message, when the module is looked up and where it is used."""
    from port_bench import readers
    from port_bench.weights import make_state_dict
    cfg = dict(tiny_file)
    if value is None:
        del cfg[key]
    else:
        cfg[key] = value
    uses = [lambda: spec.named_module(cfg, key)]
    if key == "reference":
        uses.append(lambda: make_state_dict(cfg, 1, "cpu", few_requests(tiny_file)))
    else:
        view = type("View", (), {"cfg": cfg, "trace": {}, "traced_dispatches": [object()]})
        uses.append(lambda: readers.roofline(view, "resblock"))
    for call in uses:
        with pytest.raises(error) as info:
            call()
        assert named in str(info.value)


def test_every_configuration_names_its_module():
    """Each configuration of BENCHMARK.json names, under each key of the
    contract, a bare .py file of `reference/` whose module has that key's
    names; the released model's configurations name its own two modules."""
    bench = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
    for c in bench["configs"]:
        cfg = json.load(open(os.path.join(spec.ROOT, c["file"])))
        for key, names in spec.CONTRACT.items():
            assert isinstance(cfg[key], str) and os.path.basename(cfg[key]) == cfg[key]
            assert cfg[key].endswith(".py")
            mod = spec.named_module(cfg, key)
            assert all(hasattr(mod, n) for n in names), (c["name"], key)
        if c["name"] in ("emotivoice-bf16", "emotivoice-f32"):
            assert {k: cfg[k] for k in RELEASED} == RELEASED
