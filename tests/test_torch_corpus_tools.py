"""The port's model-driving tools on the CPU at `tiny_test_config()`:
`synthesize_corpus`, `sweep_voices` and `verify_released_weights` (each
tool's `model_config` replaced by the tiny config).

- Corpus: line i gets prompt i % len(prompts) and speaker i % len(speakers),
  files `{i:06d}.txt` (written before g2p) and `.wav`; a rendered line is
  skipped on the next run; a line whose g2p fails is printed and skipped.
  Each wav equals the engine's waveform for that line's request, written as
  int16.
- Sweep: the JSONL rows and the summary carry the JAX tool's keys (read from
  its source); `--compare` against the sweep's own saved wavs gives an MAE
  no larger than one int16 step (the saved wavs are int16) and equal
  lengths; `--train-ckpt` refuses a vocabulary larger than the checkpoint's
  token table, and a speaker list larger than its speaker table.
- Released-weights check on the checkpoints `training.loop.train` wrote
  (two steps on seeded batches): the generator loads back to outputs
  bit-equal to the trained model's; gates 1-2 pass, gate 3 says "not run"
  without a reference; with a stand-in reference package (the port's own
  model under the reference's import path and output names) gate 3 passes,
  and fails when the stand-in's waveform is scaled.
- Without --device a tool needs a card, and raises without one.
"""

import ast
import json
import os
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import test_torch_support  # noqa: F401  (one intra-op thread per worker)

from emotivoice_tpu_torch.config import tiny_test_config
from emotivoice_tpu_torch.tools import synthesize_corpus, sweep_voices, verify_released_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINES = ["Hello world.", "How are you today?", "", "你好世界", "Speech synthesis at last!",
         "One more line.", "A sixth one here.", "And the last line."]
PROMPTS = ["Happy", "Sad", "Angry"]


@pytest.fixture(autouse=True)
def tiny(monkeypatch):
    for tool in (synthesize_corpus, sweep_voices, verify_released_weights):
        monkeypatch.setattr(tool, "model_config", tiny_test_config)


def _corpus_args(tmp_path, *extra):
    text = tmp_path / "lines.txt"
    text.write_text("\n".join(LINES) + "\n", encoding="utf-8")
    return ["--text-file", str(text), "--output-dir", str(tmp_path / "out"), "--device", "cpu",
            "--batch-size", "2", "--prompts", *PROMPTS, *extra]


def _g2p_fails(text):
    from emotivoice_tpu_torch.frontend.mixed import g2p_cn_en

    try:
        g2p_cn_en(text)
        return False
    except RuntimeError:
        return True


def test_corpus_round_robin_names_and_skips(tmp_path, capsys):
    stats = synthesize_corpus.main(_corpus_args(tmp_path))
    out = tmp_path / "out"
    n_speakers = tiny_test_config().am.n_speaker
    failing = {i for i, t in enumerate(LINES) if t and _g2p_fails(t)}
    assert failing == {3}  # hanzi without pypinyin
    for i, text in enumerate(LINES):
        name = f"{i:06d}"
        if not text:
            assert not (out / f"{name}.txt").exists()
            continue
        assert (out / f"{name}.txt").read_text(encoding="utf-8") == (
            f"{i % n_speakers}|{PROMPTS[i % len(PROMPTS)]}|{text}\n")
        assert (out / f"{name}.wav").exists() == (i not in failing)
    assert f"skip line 3: " in capsys.readouterr().out
    assert stats["lines"] == 7 and stats["rendered"] == 6 and stats["g2p_failed"] == 1
    # a second run renders nothing new; removing one wav renders that line only
    again = synthesize_corpus.main(_corpus_args(tmp_path))
    assert again["rendered"] == 0 and again["skipped_existing"] == 6
    os.remove(out / "000005.wav")
    assert synthesize_corpus.main(_corpus_args(tmp_path))["rendered"] == 1


def test_corpus_wavs_are_the_engines_waveforms(tmp_path):
    """Each wav is what SynthesisEngine returns for that line's request
    (speaker i % n_speakers, zero embeddings, seed-0 parameters), in int16."""
    from emotivoice_tpu_torch.frontend.mixed import g2p_cn_en
    from emotivoice_tpu_torch.serving.engine import SynthesisEngine, SynthesisRequest
    from emotivoice_tpu_torch.serving.loading import build_generator, config_and_vocab

    synthesize_corpus.main(_corpus_args(tmp_path, "--dtype", "f32"))
    cfg, vocab = config_and_vocab(tiny_test_config())
    engine = SynthesisEngine(cfg, build_generator(cfg, None, 0), vocab, device="cpu")
    zeros = np.zeros(cfg.am.bert_embedding, np.float32)
    rendered = [i for i, t in enumerate(LINES) if t and i != 3]
    reqs = [SynthesisRequest(phonemes=g2p_cn_en(LINES[i]).split(), speaker_id=i % cfg.am.n_speaker,
                             style_embedding=zeros, content_embedding=zeros) for i in rendered]
    # the tool's batches: pairs in file order
    results = [r for k in range(0, len(reqs), 2) for r in engine.synthesize_batch(reqs[k:k + 2])]
    for i, res in zip(rendered, results):
        sr, data = wavfile.read(tmp_path / "out" / f"{i:06d}.wav")
        assert sr == 16000
        np.testing.assert_array_equal(data, np.clip(res.wav * 32768, -32768, 32767).astype(np.int16))


def _jax_sweep_keys():
    """Keys of the JAX sweep tool's per-cell rows and summary, from its source."""
    tree = ast.parse(open(os.path.join(ROOT, "tools", "sweep_voices.py"), encoding="utf-8").read())
    keys = {"row": set(), "summary": set()}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Name) and t.id in keys and isinstance(node.value, ast.Dict):
                keys[t.id] |= {k.value for k in node.value.keys}
            if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                    and t.value.id in keys):
                keys[t.value.id].add(t.slice.value)
    return keys


def test_sweep_rows_and_summary_carry_the_jax_tools_keys(tmp_path):
    rows_path, wavs = tmp_path / "rows.jsonl", tmp_path / "wavs"
    args = ["--device", "cpu", "--dtype", "f32", "--limit", "3", "--batch-size", "4",
            "--prompts", *PROMPTS]
    summary = sweep_voices.main(args + ["--out", str(rows_path), "--save-wavs", str(wavs),
                                        "--report", str(tmp_path / "r.md")])
    rows = [json.loads(line) for line in open(rows_path)]
    assert len(rows) == summary["cells"] == 9 and summary["dispatches"] == 3
    assert summary["failures"] == 0 and summary["speakers"] == 3
    assert all(r["finite"] and r["ok"] for r in rows)
    assert sorted(os.listdir(wavs)) == sorted(f"{s}_{p}.wav" for s in "012" for p in PROMPTS)
    assert "# Voice sweep" in (tmp_path / "r.md").read_text()

    again = sweep_voices.main(args + ["--out", str(rows_path), "--compare", str(wavs)])
    rows2 = [json.loads(line) for line in open(rows_path)]
    want = _jax_sweep_keys()
    assert set(rows[0]) | {"ref_mae", "ref_len_delta"} == want["row"]
    assert set(rows2[0]) == want["row"]
    assert set(again) == want["summary"]
    assert all(r["ref_len_delta"] == 0 and r["ref_mae"] <= 1.0 / 32768 for r in rows2)
    assert again["ref_mae"]["max"] <= 1.0 / 32768


def test_sweep_min_peak_fails_cells():
    summary = sweep_voices.main(["--device", "cpu", "--dtype", "f32", "--limit", "1",
                                 "--prompts", "Happy", "--min-peak", "1e9"])
    assert summary["failures"] == 1 and summary["cells"] == 1


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two steps of `training.loop.train` on seeded batches (tiny config,
    the CPU): its checkpoint directory, a tokenlist of the table's size and
    the returned trainer."""
    from test_torch_train import training_batch

    from emotivoice_tpu_torch.frontend.tokens import TokenVocab
    from emotivoice_tpu_torch.training.loop import train

    root = tmp_path_factory.mktemp("trained")
    cfg = tiny_test_config()
    batches = [training_batch(cfg, seed=70 + i) for i in range(2)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)  # TensorFlow's import
        trainer = train(cfg, lambda: iter(batches), str(root / "out"), total_steps=2,
                        steps_per_epoch=2, log_every=1, device="cpu")
    tokenlist = root / "tokenlist"
    tokenlist.write_text("\n".join(TokenVocab.default().tokens[:cfg.am.n_vocab]) + "\n")
    return dict(ckpt=root / "out" / "ckpt", tokenlist=tokenlist, trainer=trainer)


def test_sweep_on_a_trained_checkpoint_and_its_table_checks(trained, tmp_path):
    ckpt = str(trained["ckpt"])
    base = ["--device", "cpu", "--dtype", "f32", "--train-ckpt", ckpt, "--prompts", "Happy",
            "--phonemes", PHONEMES]
    summary = sweep_voices.main(base + ["--tokenlist", str(trained["tokenlist"])])
    assert summary["weights"] == ckpt and summary["failures"] == 0
    assert summary["cells"] == tiny_test_config().am.n_speaker  # every row of the table
    with pytest.raises(ValueError, match="token embedding table has only"):
        sweep_voices.main(base)  # the default vocabulary is larger than the table
    speakers = tmp_path / "many_speakers"
    speakers.write_text("\n".join(str(i) for i in range(9)) + "\n")
    with pytest.raises(ValueError, match="speakers but the embedding table"):
        sweep_voices.main(base + ["--tokenlist", str(trained["tokenlist"]),
                                  "--speakers", str(speakers)])


PHONEMES = "<sos/eos> [AA1] [B] [AE1] [CH] [EY1] <sos/eos>"  # ids < 32, the tiny table
TEXTS = (f"1|Happy|{PHONEMES}|hi\n"
         "5|Sad|<sos/eos> [D] [AH0] [ER1] [DH] [AW1] [B] <sos/eos>|ho\n")


def _verify_args(trained, tmp_path, *extra):
    from emotivoice_tpu_torch.models.bert import StyleEncoder

    style = tmp_path / "style_ckpt"
    enc = StyleEncoder(tiny_test_config().bert)
    torch.save({"model": {f"module.{k}": v for k, v in enc.state_dict().items()}}, style)
    texts = tmp_path / "texts"
    texts.write_text(TEXTS)
    ckpt = trained["ckpt"]
    return ["--generator", str(ckpt / "g_00000002"), "--discriminator", str(ckpt / "do_00000002"),
            "--style-encoder", str(style), "--texts", str(texts),
            "--tokenlist", str(trained["tokenlist"]),
            "--out-dir", str(tmp_path / "rep"), "--device", "cpu", *extra]


def test_trained_checkpoint_loads_back_bit_equal(trained):
    from emotivoice_tpu_torch.convert.from_reference import load_checkpoint, load_jets_generator
    from emotivoice_tpu_torch.models.jets import JETSGenerator

    model = trained["trainer"].model.eval()
    loaded = load_jets_generator(JETSGenerator(model.cfg, kernels=False),
                                 load_checkpoint(str(trained["ckpt"] / "g_00000002"))).eval()
    rng = np.random.RandomState(5)
    d = model.cfg.am.bert_embedding
    args = [torch.as_tensor(a) for a in (rng.randint(2, 8, (2, 6)), np.array([6, 4]),
                                          np.array([1, 3]), rng.randn(2, d).astype(np.float32),
                                          rng.randn(2, d).astype(np.float32))]
    with torch.inference_mode():
        a, b = model(*args, max_frames=64), loaded(*args, max_frames=64)
    for key in ("durations", "dec_outputs", "wav_predictions", "output_lengths"):
        assert torch.equal(a[key], b[key]), key


def test_verify_released_weights_on_trained_checkpoints(trained, tmp_path):
    report = verify_released_weights.main(_verify_args(trained, tmp_path))
    assert report["gates"] == {
        "convert_generator": "ok", "convert_style_encoder": "ok", "convert_discriminator": "ok",
        "reference_model": "not run: no --reference given", "port_synthesis": "ok"}
    assert report["pass"] is False  # the released-weights gate needs the reference
    assert json.load(open(tmp_path / "rep" / "report.json")) == report
    # the wavs are the trained model's outputs for the tool's inputs, in int16
    from emotivoice_tpu_torch.frontend.tokens import TokenVocab

    model = trained["trainer"].model.eval()
    vocab = TokenVocab.from_file(str(trained["tokenlist"]))
    rng = np.random.RandomState(0)
    d = model.cfg.am.bert_embedding
    for li, line in enumerate(TEXTS.splitlines()):
        spk, _, phonemes, _ = line.split("|")
        ids = vocab.encode(phonemes.split())
        args = [torch.as_tensor(a) for a in (np.array([ids]), np.array([len(ids)]),
                                              np.array([int(spk)]),
                                              rng.randn(1, d).astype(np.float32),
                                              rng.randn(1, d).astype(np.float32))]
        with torch.inference_mode():
            out = model(*args, max_frames=verify_released_weights.MAX_FRAMES)
        n = int(out["output_lengths"][0]) * model.cfg.vocoder.upsample_factor
        wav = out["wav_predictions"][0][:n].numpy()
        _, data = wavfile.read(tmp_path / "rep" / f"utt{li}.wav")
        np.testing.assert_array_equal(data, np.clip(wav * 32768, -32768, 32767).astype(np.int16))
        assert report["utterances"][li]["n_frames"] == n // model.cfg.vocoder.upsample_factor


def test_verify_released_weights_refuses_a_broken_checkpoint(trained, tmp_path):
    ckpt = torch.load(trained["ckpt"] / "g_00000002", weights_only=True)
    del ckpt["generator"]["generator.conv_post.weight_v"]
    torch.save(ckpt, tmp_path / "g_broken")
    args = _verify_args(trained, tmp_path)
    args[1] = str(tmp_path / "g_broken")
    with pytest.raises(KeyError, match="generator checkpoint lacks"):
        verify_released_weights.main(args)


STAND_IN = '''
"""Stand-in for the reference repository's JETSGenerator: the port's model
under the reference's import path, config argument and output names."""
import torch
from emotivoice_tpu_torch.config import tiny_test_config
from emotivoice_tpu_torch.models.jets import JETSGenerator as _Port

WAV_SCALE = {scale}


class JETSGenerator(torch.nn.Module):
    def __init__(self, config):
        super().__init__()
        self.config = config

    def load_state_dict(self, sd):
        cfg = tiny_test_config()
        cfg = cfg.replace(am=cfg.am.__class__(**{{
            **cfg.am.__dict__, "n_speaker": sd["am.spk_tokenizer.weight"].shape[0],
            "n_vocab": sd["am.src_word_emb.weight"].shape[0]}}))
        self.inner = _Port(cfg).train(self.training)
        return self.inner.load_state_dict(sd)

    def forward(self, tokens, lengths, speaker, style, content):
        ds = self.inner(tokens, lengths, speaker, style, content, max_frames=1024)["durations"]
        out = self.inner(tokens, lengths, speaker, style, content,
                         max_frames=int(ds[0].sum()))
        return {{"log_duration_predictions": ds, "dec_outputs": out["dec_outputs"],
                "wav_predictions": out["wav_predictions"][:, None] * WAV_SCALE}}
'''


@pytest.mark.parametrize("scale,passes", [(1.0, True), (1.5, False)])
def test_gate_three_with_a_stand_in_reference(trained, tmp_path, monkeypatch, scale, passes):
    ref = tmp_path / "reference"
    pkg = ref / "models" / "prompt_tts_modified"
    pkg.mkdir(parents=True)
    (ref / "models" / "__init__.py").write_text("")
    (pkg / "__init__.py").write_text("")
    (pkg / "jets.py").write_text(STAND_IN.format(scale=scale))
    monkeypatch.setattr(sys, "path", list(sys.path))
    before = set(sys.modules)
    assert not any(m == "models" or m.startswith("models.") for m in before)
    try:
        report = verify_released_weights.main(_verify_args(trained, tmp_path,
                                                           "--reference", str(ref)))
    finally:
        for name in set(sys.modules) - before:  # the stand-in and the numba stub
            if name in ("numba", "models") or name.startswith("models."):
                del sys.modules[name]
    assert report["gates"]["reference_model"] == "loaded"
    assert report["gates"]["reference_parity"] == ("ok" if passes else "failed")
    assert report["pass"] is passes
    for row in report["utterances"]:
        assert row["durations_equal"] and row["mel_mae"] == 0.0
        assert (row["wav_mae"] == 0.0) == passes


def test_tools_need_a_card_without_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthesize_corpus.main(_corpus_args(tmp_path)[:4])  # no --device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep_voices.main(["--limit", "1"])
