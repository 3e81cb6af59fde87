"""Style-encoder pretraining in the port against the JAX package's, on the
CPU (a 2-layer, 16-wide StyleBertConfig; seeded parameters and batches).

- Dropout: the encoder has BERT's five dropouts (embeddings, attention
  probabilities, attention output, feed-forward output, one per head), all
  the identity in `eval()`, active in `train()`.
- Gradients: one `PretrainStep` (every dropout rate 0) against `jax.grad` of
  the JAX loss (`style_pretrain_loss` of the JAX `StyleEncoder`,
  deterministic): every tensor within GRAD_TOL of its max, or of FLOOR x
  the model's largest gradient where its own is smaller (those are 0 in
  exact arithmetic: attention key biases).
- Trajectory: three steps of JAX `make_pretrain_step` (its dropouts made
  rate 0 for the test) and of `PretrainStep`, at lr 1e-3: every metric
  within LOSS_RTOL and every parameter within PARAM_TOL of its max (round-
  off-gradient tensors, which Adam moves by about lr a step whatever the
  sign, within 2 x lr x steps).
- The optimizer is optax.adamw's: its defaults read from its signature.
- `pretrain` turns TF32 off and logs with the JAX package's prefix.
"""

import inspect

import numpy as np
import pytest
import torch

import jax

from test_torch_support import jax_style_params, port_style_encoder

import emotivoice_tpu.models.bert as jbert
from emotivoice_tpu.config import StyleBertConfig as JStyleBertConfig
from emotivoice_tpu.convert.from_torch import convert_style_encoder
from emotivoice_tpu.training import style_pretrain as jsp
from emotivoice_tpu_torch.config import StyleBertConfig
from emotivoice_tpu_torch.models.bert import StyleEncoder
from emotivoice_tpu_torch.training.style_pretrain import ATTRIBUTES, PretrainStep, pretrain

GRAD_TOL = 1e-4  # the CPU shows <= 1.1e-6 on tensors held to their own max
FLOOR = 1e-2  # every real gradient here is > 6% of the largest; key biases ~1e-8 of it
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-4
SIZE = dict(vocab_size=50, hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32,
            max_position_embeddings=32)
STEPS, LR = 3, 1e-3


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = JStyleBertConfig(**SIZE), StyleBertConfig(**SIZE)
    return jcfg, tcfg, jax_style_params(jcfg, seed=11)


def _batch(cfg, seed, b=4, t=10):
    rng = np.random.RandomState(seed)
    out = {"input_ids": rng.randint(0, cfg.vocab_size, (b, t)),
           "token_type_ids": rng.randint(0, cfg.type_vocab_size, (b, t)),
           "attention_mask": (np.arange(t)[None] < np.array([10, 7, 4, 2])[:, None]).astype(
               np.int64)}
    for a in ATTRIBUTES:
        out[a] = rng.randint(0, getattr(cfg, f"{a}_n_labels"), (b,))
    return out


def _torch(batch):
    return {k: torch.as_tensor(v).long() for k, v in batch.items()}


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def test_five_dropouts_active_in_train_only(setup):
    _, tcfg, params = setup
    model = port_style_encoder(tcfg, params)
    drops = {n for n, m in model.named_modules() if isinstance(m, torch.nn.Dropout)}
    layers = [f"bert.encoder.layer.{i}." for i in range(tcfg.num_layers)]
    assert drops == ({"bert.embeddings.dropout"}
                     | {f"{x}{site}.dropout" for x in layers
                        for site in ("attention.self", "attention.output", "output")}
                     | {f"{a}_clf.dropout" for a in ATTRIBUTES})
    x = _torch(_batch(tcfg, 0))
    args = (x["input_ids"], x["token_type_ids"], x["attention_mask"])
    with torch.no_grad():
        ref = model.eval()(*args)["pitch_outputs"]
        again = model(*args)["pitch_outputs"]
        plain = _no_dropout(port_style_encoder(tcfg, params)).train()(*args)["pitch_outputs"]
        torch.manual_seed(0)
        dropped = model.train()(*args)["pitch_outputs"]
    assert torch.equal(ref, again) and torch.equal(ref, plain)
    assert not torch.allclose(dropped, ref, atol=1e-3)


def _jax_loss(jcfg):
    model = jbert.StyleEncoder(jcfg)

    def loss(p, batch):
        out = model.apply({"params": p}, batch["input_ids"], batch["token_type_ids"],
                          batch["attention_mask"], deterministic=True)
        return sum(jsp.style_pretrain_loss(out, batch).values())

    return loss


def _close(name, got, want, floor, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(np.abs(want).max(), floor)
    assert np.abs(got - want).max() <= tol * scale, (name, np.abs(got - want).max(), scale)


def test_pretrain_step_gradients_match_jax(setup):
    jcfg, tcfg, params = setup
    batch = _batch(tcfg, 1)
    want = jax.grad(_jax_loss(jcfg))(params["params"], batch)
    model = _no_dropout(port_style_encoder(tcfg, params))
    step = PretrainStep(model, learning_rate=0.0)
    metrics = step(_torch(batch))
    got = convert_style_encoder({k: p.grad for k, p in model.named_parameters()},
                                tcfg.num_layers)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    floor = FLOOR * max(np.abs(w).max() for _, w in flat)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, w), g in zip(flat, jax.tree_util.tree_leaves(got)):
        _close(jax.tree_util.keystr(path), g, w, floor, GRAD_TOL)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(_jax_loss(jcfg)(params["params"], batch)), rtol=LOSS_RTOL)


class _RateZero:
    """flax.linen as the JAX encoder sees it, with every Dropout at rate 0."""

    def __init__(self, nn):
        self._nn = nn

    def __getattr__(self, name):
        if name == "Dropout":
            return lambda rate, **kw: self._nn.Dropout(0.0, **kw)
        return getattr(self._nn, name)


def test_three_steps_match_make_pretrain_step(setup, monkeypatch):
    jcfg, tcfg, params = setup
    monkeypatch.setattr(jbert, "nn", _RateZero(jbert.nn))
    step_fn, opt = jsp.make_pretrain_step(jbert.StyleEncoder(jcfg), learning_rate=LR)
    p, opt_state, rng = params["params"], opt.init(params["params"]), jax.random.PRNGKey(0)
    model = _no_dropout(port_style_encoder(tcfg, params))
    step = PretrainStep(model, learning_rate=LR)
    first = None
    for i in range(STEPS):
        batch = _batch(tcfg, 10 + i)
        grads = jax.grad(_jax_loss(jcfg))(p, batch)  # which tensors' gradients are round-off
        p, opt_state, rng, want = step_fn(p, opt_state, rng, batch)
        got = step(_torch(batch))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL,
                                       err_msg=f"step {i + 1} {k}")
        first = first or float(want["loss"])
        flat = jax.tree_util.tree_leaves(grads)
        largest = max(np.abs(g).max() for g in flat)
    assert abs(float(want["loss"]) - first) > 0.01  # the losses moved
    got = convert_style_encoder({k: v.detach() for k, v in model.named_parameters()},
                                tcfg.num_layers)
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(p))[0]
    for (path, w), g, grad in zip(flat, jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(
            grads)):
        w = np.asarray(w)
        if np.abs(grad).max() < FLOOR * largest:
            np.testing.assert_allclose(g, w, rtol=0, atol=2 * LR * STEPS)
        else:
            _close(jax.tree_util.keystr(path), g, w, 0.0, PARAM_TOL)


def test_optimizer_is_optax_adamw():
    opt = PretrainStep(StyleEncoder(StyleBertConfig(**SIZE))).opt
    group = opt.param_groups[0]
    defaults = inspect.signature(jsp.optax.adamw).parameters
    assert isinstance(opt, torch.optim.AdamW)
    assert group["lr"] == inspect.signature(jsp.make_pretrain_step).parameters[
        "learning_rate"].default == 2e-5
    assert group["betas"] == (defaults["b1"].default, defaults["b2"].default) == (0.9, 0.999)
    assert group["eps"] == defaults["eps"].default == 1e-8
    assert group["weight_decay"] == defaults["weight_decay"].default == 1e-4
    assert defaults["eps_root"].default == 0.0


def test_pretrain_turns_tf32_off_and_logs(setup, monkeypatch):
    _, tcfg, params = setup
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)

    class Log:
        lines = []

        def log(self, step, metrics, prefix):
            self.lines.append((step, prefix, sorted(metrics)))

    logger = Log()
    model = port_style_encoder(tcfg, params)
    batches = [_batch(tcfg, i) for i in range(3)]
    out = pretrain(model, batches, total_steps=2, log_every=1, logger=logger, device="cpu")
    assert out is model and model.training
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (
        False, False)
    want = sorted([f"{a}_loss" for a in ATTRIBUTES] + [f"{a}_acc" for a in ATTRIBUTES]
                  + ["loss"])
    assert logger.lines == [(1, "style_pretrain", want), (2, "style_pretrain", want)]
