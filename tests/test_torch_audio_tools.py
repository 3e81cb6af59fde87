"""The port's native wav codec, resampler, corpus recipes and frontend-golden
tool on the CPU, against scipy and the JAX package.

- Codec: the port's own build of `emotivoice_tpu_torch/native/audio_io.cc`
  against scipy, as `tests/test_native.py` holds the JAX package's (int16
  quantisation only; trim equal to the Python path; resample within 5e-3 of
  `resample_poly` away from the edges). These tests skip only when no g++
  is on PATH: a compiler that fails on the source fails them.
- Resample, port vs JAX, on one backend at a time: the JAX package's copy
  of the C++ source built privately (its own build directory is left to
  its own tests) against the port's build, and scipy against scipy with the
  library forced off in both; equal within 1e-6.
- Two processes building the library at once both load it.
- `prepare_ljspeech` / `prepare_databaker`, port vs the JAX tools (run with
  runpy) on one synthetic corpus per recipe at 22.05 and 44.1 kHz, on each
  backend: datalists byte-equal, wavs sample-equal (1e-6 of full scale is
  below one int16 step).
- `parse_label_pair` / `tokens_to_phonemes` equal to the JAX tool's.
- `record_frontend_goldens --check` passes; recording reproduces the
  fixture byte for byte (into a copy).
"""

import json
import os
import runpy
import shutil
import subprocess
import sys
import textwrap
from math import gcd

import numpy as np
import pytest
from scipy.io import wavfile
from scipy.signal import resample_poly

import test_torch_support  # noqa: F401  (one intra-op thread per worker)

from emotivoice_tpu.utils import audio_io as jaudio
from emotivoice_tpu.utils import native as jnative
from emotivoice_tpu_torch.tools import prepare_databaker, prepare_ljspeech
from emotivoice_tpu_torch.tools import record_frontend_goldens as goldens
from emotivoice_tpu_torch.utils import audio_io
from emotivoice_tpu_torch.utils import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MAKE_FLAGS = ["-O3", "-march=native", "-fPIC", "-Wall", "-Wextra", "-std=c++17", "-shared"]


@pytest.fixture()
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the port falls back to scipy")
    assert native.load() is not None and native.backend() == "native"


@pytest.fixture(scope="module")
def jax_native_lib(tmp_path_factory):
    """The JAX package's C++ source built with its Makefile's flags into a
    private directory."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH")
    out = str(tmp_path_factory.mktemp("jax_native") / "libemotivoice_audio.so")
    subprocess.run(["g++", *JAX_MAKE_FLAGS, "-o", out, os.path.join(ROOT, "native", "audio_io.cc")],
                   check=True, capture_output=True, timeout=300)
    return out


@pytest.fixture(params=["native", "scipy"])
def backend(request, monkeypatch, tmp_path):
    """Both packages on one backend."""
    if request.param == "native":
        request.getfixturevalue("lib")
        monkeypatch.setattr(jnative, "_LIB_PATH", request.getfixturevalue("jax_native_lib"))
        monkeypatch.setattr(jnative, "_NATIVE_DIR", str(tmp_path / "no_make"))
        monkeypatch.setattr(jnative, "_lib", None)
        monkeypatch.setattr(jnative, "_tried", False)
        assert jnative.available()
    else:
        monkeypatch.setattr(jnative, "load", lambda: None)
        monkeypatch.setattr(native, "load", lambda: None)
        assert native.backend() == "scipy"
    return request.param


def _tones(sr, seconds=1.0):
    t = np.arange(int(sr * seconds), dtype=np.float64) / sr
    return (0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1700 * t)).astype(np.float32)


@pytest.fixture()
def sine():
    t = np.arange(16000, dtype=np.float32) / 16000
    return (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)


# ---------------------------------------------------------------------------
# the codec against scipy
# ---------------------------------------------------------------------------

def test_write_read_round_trip_matches_scipy(lib, sine, tmp_path):
    path = str(tmp_path / "a.wav")
    audio_io.write_wav(path, sine, 16000)
    sr, wav = audio_io.read_wav(path)
    assert sr == 16000
    np.testing.assert_allclose(wav, sine, atol=1.0 / 32768 + 1e-7)
    _, raw = wavfile.read(path)
    np.testing.assert_array_equal(raw, np.clip(sine * 32768, -32768, 32767).astype(np.int16))
    # the file-object path (the HTTP service's) writes the same bytes
    import io

    buf = io.BytesIO()
    audio_io.write_wav(buf, sine, 16000)
    assert buf.getvalue() == open(path, "rb").read()


def test_read_stereo_mixes_to_mono(lib, sine, tmp_path):
    path = str(tmp_path / "st.wav")
    wavfile.write(path, 16000, (np.stack([sine, -sine], axis=1) * 32767).astype(np.int16))
    _, wav = audio_io.read_wav(path)
    assert wav.ndim == 1 and np.abs(wav).max() < 1e-4  # the channels cancel


def test_read_float32_wav(lib, sine, tmp_path):
    path = str(tmp_path / "f.wav")
    wavfile.write(path, 16000, sine)  # IEEE float format
    _, wav = audio_io.read_wav(path)
    np.testing.assert_allclose(wav, sine, atol=1e-6)


def test_trim_matches_the_python_path(lib, sine, monkeypatch):
    sig = np.concatenate([np.zeros(4000, np.float32), sine, np.zeros(4000, np.float32)])
    got = audio_io.trim_silence(sig, 16000)
    monkeypatch.setattr(native, "load", lambda: None)
    want = audio_io.trim_silence(sig, 16000)
    assert len(want) < len(sig)
    np.testing.assert_array_equal(got, want)
    silent = np.zeros(1000, np.float32)
    assert len(audio_io.trim_silence(silent, 16000)) == 1000


@pytest.mark.parametrize("sr_in", [48000, 22050, 44100])
def test_resample_close_to_scipy_polyphase(lib, sr_in):
    x = _tones(sr_in)
    y = audio_io.resample(x, sr_in, 16000)
    g = gcd(16000, sr_in)
    y_ref = resample_poly(x, 16000 // g, sr_in // g).astype(np.float32)
    n = min(len(y), len(y_ref))
    assert np.abs(y[200:n - 200] - y_ref[200:n - 200]).max() < 5e-3  # edges excluded


def test_resample_identity(lib):
    x = np.random.RandomState(0).randn(1000).astype(np.float32)
    np.testing.assert_array_equal(audio_io.resample(x, 16000, 16000), x)


# ---------------------------------------------------------------------------
# port vs JAX, one backend at a time
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sr_in", [22050, 44100])
def test_resample_equals_jax_on_the_same_backend(backend, sr_in):
    x = _tones(sr_in, 0.5)
    got = audio_io.resample(x, sr_in, 16000)
    want = jaudio.resample(x, sr_in, 16000)
    assert native.backend() == backend
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6


def test_two_processes_building_at_once_both_load(lib, tmp_path):
    """A fresh build directory and four processes started together: each
    waits for the lock, none loads a half-written library."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        from emotivoice_tpu_torch.utils import native
        native.BUILD_DIR = {str(tmp_path / "build")!r}
        out = native.resample(np.ones(4410, np.float32), 44100, 16000)
        print(native.backend(), len(out), float(out[800]))
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["native", "1600", "1.0"], out
    assert sorted(os.listdir(tmp_path / "build")) == [
        "libemotivoice_audio.so", "lock", "source.sha256"]


# ---------------------------------------------------------------------------
# corpus recipes, port vs JAX
# ---------------------------------------------------------------------------

LJ_LINES = ["Printing, in the only sense with which we are at present concerned.",
            "Is this the right way?", "Hello world.", "The quick brown fox jumps.",
            "Speech synthesis at last!"]

DB_PAIRS = [  # (key, text line, pinyin line): erhua fused and not, both fixes, a missing wav
    ("000001", "你#1去哪儿#3。", "ni3 qu4 na3r"),
    ("000002", "我#2爱#1中国#4。", "wo3 ai4 zhong1 guo2"),
    ("002365", "坏#4。", "huai4"),
    ("000004", "一会儿#2见#4。", "yi2 hui4 er5 jian4"),
    ("005107", "生嗯#4。", "sheng1 ng1"),
    ("000005", "小孩儿#1玩#4。", "xiao3 har2 wan2"),
    ("000006", "没有#4。", "mei2 you3"),
]


def _write_wav(path, sr, seed, seconds=0.25):
    x = 0.3 * _tones(sr, seconds) + 0.01 * np.random.RandomState(seed).randn(int(sr * seconds))
    wavfile.write(path, sr, np.clip(x * 32768, -32768, 32767).astype(np.int16))


def ljspeech_corpus(root, sr=22050):
    os.makedirs(os.path.join(root, "wavs"))
    with open(os.path.join(root, "metadata.csv"), "w", encoding="utf-8") as f:
        for i, text in enumerate(LJ_LINES):
            key = f"LJ001-{i + 1:04d}"
            f.write(f"{key}|{text}|{text}\n")
            _write_wav(os.path.join(root, "wavs", f"{key}.wav"), sr, i)
    return root


def databaker_corpus(root, sr=44100):
    os.makedirs(os.path.join(root, "ProsodyLabeling"))
    os.makedirs(os.path.join(root, "Wave"))
    with open(os.path.join(root, "ProsodyLabeling", "000001-010000.txt"), "w",
              encoding="utf-8") as f:
        for i, (key, text, pinyin) in enumerate(DB_PAIRS):
            f.write(f"{key}\t{text}\n\t{pinyin}\n")
            if key != "000006":
                _write_wav(os.path.join(root, "Wave", f"{key}.wav"), sr, i)
    return root


def _run_jax_tool(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name] + argv)
    runpy.run_path(os.path.join(ROOT, "tools", f"{name}.py"), run_name="__main__")


def _compare_outputs(jax_out, port_out):
    files = sorted(os.path.relpath(os.path.join(d, n), jax_out)
                   for d, _, names in os.walk(jax_out) for n in names)
    assert files == sorted(os.path.relpath(os.path.join(d, n), port_out)
                           for d, _, names in os.walk(port_out) for n in names)
    for rel in files:
        a, b = os.path.join(jax_out, rel), os.path.join(port_out, rel)
        if rel.endswith(".jsonl"):
            assert open(a, "rb").read() == open(b, "rb").read(), rel
        else:
            (sa, wa), (sb, wb) = wavfile.read(a), wavfile.read(b)
            assert sa == sb == 16000 and wa.dtype == wb.dtype == np.int16
            np.testing.assert_array_equal(wa, wb)
    return files


@pytest.mark.parametrize("recipe", ["ljspeech", "databaker"])
def test_recipe_equals_the_jax_tool(recipe, backend, tmp_path, monkeypatch, capsys):
    corpus = (ljspeech_corpus if recipe == "ljspeech" else databaker_corpus)(
        str(tmp_path / "corpus"))
    out = str(tmp_path / "out")  # the same path for both: wav_path is absolute
    argv = ["--corpus", corpus, "--output", out]
    _run_jax_tool(f"prepare_{recipe}", argv, monkeypatch)
    os.rename(out, out + "_jax")
    tool = prepare_ljspeech if recipe == "ljspeech" else prepare_databaker
    summary = tool.main(argv)
    files = _compare_outputs(out + "_jax", out)
    n_wavs = sum(f.endswith(".wav") for f in files)
    assert summary == {"utterances": n_wavs, "resampled": n_wavs, "resample_backend": backend}
    valid = [json.loads(line) for line in open(os.path.join(out, "valid", "datalist.jsonl"),
                                               encoding="utf-8")]
    assert len(valid) == 3
    if recipe == "databaker":
        keys = [json.loads(line)["key"] for line in open(
            os.path.join(out, "train", "datalist.jsonl"), encoding="utf-8")]
        assert keys + [r["key"] for r in valid] == ["000001", "000002", "000004", "005107",
                                                     "000005"]
        assert "missing wav" in capsys.readouterr().out
    else:
        assert valid[-1]["text"][-2:] == [".", "<sos/eos>"]
    # a second run resamples nothing and writes the same datalists
    assert tool.main(argv)["resampled"] == 0
    _compare_outputs(out + "_jax", out)


def test_databaker_labels_only(tmp_path):
    corpus = databaker_corpus(str(tmp_path / "corpus"))
    summary = prepare_databaker.main(["--corpus", corpus, "--output", str(tmp_path / "o"),
                                      "--skip-audio"])
    assert summary["utterances"] == 6 and summary["resampled"] == 0  # 000006 kept
    assert os.listdir(tmp_path / "o" / "wavs") == []


@pytest.fixture(scope="module")
def jax_databaker():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_prepare_databaker", os.path.join(ROOT, "tools", "prepare_databaker.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("text,pinyin", [(t, p) for _, t, p in DB_PAIRS]
                         + [("卡尔普#2陪外孙#1玩滑梯#4。", "ka3 er3 pu3 pei2 wai4 sun1 wan2 hua2 ti1")])
def test_label_parsing_equals_the_jax_tool(jax_databaker, text, pinyin):
    tokens = prepare_databaker.parse_label_pair(text, pinyin)
    assert tokens == jax_databaker.parse_label_pair(text, pinyin)
    assert (prepare_databaker.tokens_to_phonemes(tokens)
            == jax_databaker.tokens_to_phonemes(tokens))


def test_label_parsing_cases_of_the_jax_tests(jax_databaker):
    tokens = prepare_databaker.parse_label_pair("你#1去哪儿#3。", "ni3 qu4 na3r")
    assert tokens == ["ni3", "#1", "qu4", "#0", "na3r", "#3"]
    assert prepare_databaker.tokens_to_phonemes(["zhong1", "#1", "er2"]) == [
        "zh", "ong1", "sp1", "er2"]
    assert prepare_databaker.PUNCT_RE.pattern == jax_databaker.PUNCT_RE.pattern
    assert prepare_databaker.PROSODY == jax_databaker.PROSODY


# ---------------------------------------------------------------------------
# frontend goldens
# ---------------------------------------------------------------------------

def test_frontend_goldens_check_passes(capsys):
    res = goldens.main(["--check"])
    assert res["checked"] >= 31 and res["checked"] + res["skipped"] == 42
    assert capsys.readouterr().out.startswith("OK: ")


def test_recording_reproduces_the_fixture(tmp_path, monkeypatch):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_goldens", os.path.join(ROOT, "tools", "record_frontend_goldens.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    for cases in ("SYLLABLE_CASES", "EN_CASES", "HANZI_CASES", "MIXED_CASES"):
        assert getattr(goldens, cases) == getattr(jax_tool, cases), cases
    copy = tmp_path / "frontend_goldens.jsonl"
    shutil.copy(goldens.FIXTURE, copy)
    monkeypatch.setattr(goldens, "FIXTURE", str(copy))
    assert goldens.main([]) == {"written": 42}
    assert copy.read_bytes() == open(os.path.join(ROOT, "tests", "fixtures",
                                                  "frontend_goldens.jsonl"), "rb").read()


def test_tools_run_as_modules():
    for name in ("synthesize_corpus", "sweep_voices", "verify_released_weights",
                 "prepare_ljspeech", "prepare_databaker"):
        res = subprocess.run([sys.executable, "-m", f"emotivoice_tpu_torch.tools.{name}", "--help"],
                             capture_output=True, text=True, timeout=120, cwd=ROOT)
        assert res.returncode == 0 and "usage:" in res.stdout, (name, res.stderr)
    res = subprocess.run([sys.executable, "-m", "emotivoice_tpu_torch.tools.record_frontend_goldens",
                          "--check"], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0 and res.stdout.startswith("OK: "), res.stderr
