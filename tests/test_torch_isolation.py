"""The port stands alone: every module of emotivoice_tpu_torch imports with
jax and flax blocked and loads nothing of the JAX package, and
chip_smoke.py imports neither."""

import os
import re
import subprocess
import sys
import textwrap

import test_torch_support  # noqa: F401  (one intra-op thread per worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINING_SLICE = {f"emotivoice_tpu_torch.{m}" for m in (
    "ops.stft", "ops.mel", "ops.pitch", "ops.segments", "ops.align",
    "models.discriminator", "training", "training.losses", "training.step",
    "training.validate", "training.loop", "data", "data.dataset", "data.synthetic_corpus",
    "train")}
PARALLEL_SLICE = {f"emotivoice_tpu_torch.{m}" for m in (
    "parallel", "parallel.multihost", "parallel.data_parallel", "training.style_pretrain",
    "serve", "serving.engine", "serving.programs")}
TOOLS_SLICE = {f"emotivoice_tpu_torch.{m}" for m in (
    "utils.native", "utils.audio_io", "tools", "tools.synthesize_corpus", "tools.sweep_voices",
    "tools.verify_released_weights", "tools.prepare_ljspeech", "tools.prepare_databaker",
    "tools.record_frontend_goldens")}
PKG = os.path.join(ROOT, "emotivoice_tpu_torch")


def test_every_port_module_imports_without_jax():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "flax", "optax"):
            sys.modules[name] = None  # any import of them raises ImportError
        sys.path.insert(0, {ROOT!r})
        import emotivoice_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            emotivoice_tpu_torch.__path__, "emotivoice_tpu_torch.")]
        for n in names:
            importlib.import_module(n)
        leaked = sorted(m for m in sys.modules
                        if m == "emotivoice_tpu" or m.startswith("emotivoice_tpu."))
        print(" ".join(names))
        print(leaked)
        assert not leaked, leaked
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    names, leaked = res.stdout.strip().splitlines()[-2:]
    names = set(names.split())
    assert len(names) >= 60 and leaked == "[]"
    assert TRAINING_SLICE <= names, sorted(TRAINING_SLICE - names)
    assert PARALLEL_SLICE <= names, sorted(PARALLEL_SLICE - names)
    assert TOOLS_SLICE <= names, sorted(TOOLS_SLICE - names)


def test_no_source_line_imports_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(import|from) +(jax|flax|emotivoice_tpu)\b")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    bad = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f, 1):
                if pat.match(line):
                    bad.append(f"{os.path.relpath(path, ROOT)}:{i}: {line.strip()}")
    assert not bad, bad


def test_chip_smoke_fails_without_a_card():
    """No card: non-zero exit and no result line."""
    code = textwrap.dedent(f"""
        import runpy, sys, torch
        torch.cuda.is_available = lambda: False
        sys.argv = ["chip_smoke.py"]
        runpy.run_path({os.path.join(ROOT, "chip_smoke.py")!r}, run_name="__main__")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
