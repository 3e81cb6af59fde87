"""The port's SimBERT style encoder against the JAX one on the CPU, at
tiny_test_config size: same seeded parameters and inputs through both."""

import numpy as np
import pytest
import torch

from test_torch_support import (
    StandInTokenizer,
    assert_close_rel,
    both_configs,
    jax_style_params,
    port_style_encoder,
)

from emotivoice_tpu.convert.from_torch import convert_style_encoder
from emotivoice_tpu.models.bert import StyleEncoder as JStyleEncoder
from emotivoice_tpu.serving.style import StyleEmbedder as JStyleEmbedder
from emotivoice_tpu_torch.config import StyleBertConfig
from emotivoice_tpu_torch.models.bert import StyleEncoder
from emotivoice_tpu_torch.serving.style import StyleEmbedder

TOL = 1e-5  # of max |ref|, f32
OUTPUTS = ("pooled_output", "pitch_outputs", "speed_outputs", "energy_outputs",
           "emotion_outputs")


@pytest.fixture(scope="module")
def pair():
    jc, tc = both_configs()
    params = jax_style_params(jc.bert, seed=5)
    return jc.bert, tc.bert, params, port_style_encoder(tc.bert, params)


def _inputs(cfg, b=4, t=17, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (b, t))
    types = rng.randint(0, cfg.type_vocab_size, (b, t))
    mask = (np.arange(t)[None, :] < np.array([t, t - 5, 3, 1])[:b, None]).astype(np.int64)
    return ids, types, mask


@pytest.mark.parametrize("name", OUTPUTS)
def test_style_encoder_matches_jax_with_ragged_mask(pair, name):
    jb, tb, params, model = pair
    ids, types, mask = _inputs(jb)
    want = JStyleEncoder(jb).apply(params, ids, types, mask)
    with torch.no_grad():
        got = model(*(torch.as_tensor(a) for a in (ids, types, mask)))
    assert got[name].shape == tuple(want[name].shape)
    assert_close_rel(got[name].numpy(), want[name], TOL)


def test_defaults_no_mask_no_token_types(pair):
    jb, tb, params, model = pair
    ids, _, _ = _inputs(jb, seed=1)
    want = JStyleEncoder(jb).apply(params, ids)["pooled_output"]
    with torch.no_grad():
        got = model(torch.as_tensor(ids))["pooled_output"]
    assert_close_rel(got.numpy(), want, TOL)


def test_padded_queries_still_produce_rows(pair):
    """The mask is on keys only: last_hidden_state at padded positions is
    finite and equals the JAX one."""
    jb, tb, params, model = pair
    from emotivoice_tpu.models.bert import BertModel as JBert

    ids, types, mask = _inputs(jb, seed=2)
    want = JBert(jb).apply({"params": params["params"]["bert"]}, ids, types, mask)
    with torch.no_grad():
        got = model.bert(*(torch.as_tensor(a) for a in (ids, types, mask)))
    assert np.all(np.isfinite(got["last_hidden_state"].numpy()))
    assert_close_rel(got["last_hidden_state"].numpy(), want["last_hidden_state"], TOL)


def test_state_dict_round_trips_through_convert_style_encoder(pair):
    jb, tb, params, model = pair
    sd = {f"module.{k}": v.numpy() for k, v in model.state_dict().items()}
    back = convert_style_encoder({"model": sd}, tb.num_layers)
    import jax

    want = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf)


def test_state_dict_uses_hf_bert_names():
    keys = set(StyleEncoder(both_configs()[1].bert).state_dict())
    for k in ("bert.embeddings.word_embeddings.weight", "bert.embeddings.LayerNorm.bias",
              "bert.encoder.layer.0.attention.self.query.weight",
              "bert.encoder.layer.0.attention.output.dense.bias",
              "bert.encoder.layer.0.attention.output.LayerNorm.weight",
              "bert.encoder.layer.0.intermediate.dense.weight",
              "bert.encoder.layer.0.output.dense.weight",
              "bert.encoder.layer.0.output.LayerNorm.bias", "bert.pooler.dense.weight",
              "pitch_clf.classifier.weight", "emotion_clf.classifier.bias"):
        assert k in keys, k


def test_full_width_parameter_count():
    """StyleBertConfig() is BERT base: 12 layers, 768-d, vocab 13685."""
    cfg = StyleBertConfig()
    with torch.device("meta"):
        n = sum(p.numel() for p in StyleEncoder(cfg).bert.parameters())
    emb = (cfg.vocab_size + cfg.max_position_embeddings + cfg.type_vocab_size + 2) * 768
    layer = 4 * (768 * 768 + 768) + 2 * 768 * 3072 + 3072 + 768 + 4 * 768
    assert n == emb + 12 * layer + 768 * 768 + 768


TEXTS = ["Happy", "a much longer prompt, with punctuation!", "悲伤", ""]


def test_embedder_matches_jax_embedder(pair):
    jb, tb, params, model = pair
    tok = StandInTokenizer(jb.vocab_size)
    want = JStyleEmbedder(params, jb, tok, max_len=16).embed_batch(TEXTS)
    emb = StyleEmbedder(model, tb, tok, max_len=16, device="cpu")
    got = emb.embed_batch(TEXTS)
    assert got.dtype == np.float32 and got.shape == (4, tb.hidden_size)
    assert_close_rel(got, want, TOL)
    np.testing.assert_array_equal(emb.embed(TEXTS[1]), emb.embed_batch([TEXTS[1]])[0])


def test_embedder_from_reference_checkpoint(pair, tmp_path):
    """A reference-layout checkpoint ({'model': ...}, `module.` prefixes, a
    buffer the module lacks) loads; one that lacks a parameter raises."""
    jb, tb, params, model = pair
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    sd["module.bert.embeddings.position_ids"] = torch.arange(tb.max_position_embeddings)[None]
    path = tmp_path / "checkpoint_1"
    torch.save({"model": sd}, path)
    emb = StyleEmbedder.from_checkpoint(str(path), tb, device="cpu")
    emb.tokenizer = StandInTokenizer(tb.vocab_size)
    ref = StyleEmbedder(model, tb, emb.tokenizer, device="cpu")
    np.testing.assert_array_equal(emb.embed("Happy"), ref.embed("Happy"))

    del sd["module.bert.pooler.dense.weight"]
    torch.save({"model": sd}, path)
    with pytest.raises(KeyError, match="bert.pooler.dense.weight"):
        StyleEmbedder.from_checkpoint(str(path), tb, device="cpu")


def test_embedder_defaults_to_the_card(pair, monkeypatch):
    jb, tb, params, model = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StyleEmbedder(model, tb, StandInTokenizer(tb.vocab_size))


def test_embedder_needs_a_tokenizer(pair):
    jb, tb, params, model = pair
    with pytest.raises(AssertionError, match="tokenizer"):
        StyleEmbedder(model, tb, device="cpu").embed("x")


def test_embed_batch_from_threads(pair):
    """embed_batch enters inference mode itself, so handler threads may call
    it directly and get the main thread's answer."""
    import threading

    jb, tb, params, model = pair
    emb = StyleEmbedder(model, tb, StandInTokenizer(tb.vocab_size), max_len=16, device="cpu")
    want = emb.embed_batch(TEXTS)
    got = [None] * 4

    def work(i):
        got[i] = emb.embed(TEXTS[i])

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for i in range(4):
        np.testing.assert_allclose(got[i], want[i], atol=1e-6)
