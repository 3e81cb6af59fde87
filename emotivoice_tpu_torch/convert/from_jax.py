"""JAX param tree -> port state dict (the mirror of
`emotivoice_tpu/convert/from_torch.py`).

`jax_to_torch_state_dict(params, cfg)` takes the JAX `JETSGenerator`
variables `{'params': {'am': ..., 'generator': ...}}` (or the inner dict),
as numpy arrays, and returns a state dict for the port's `JETSGenerator`.
Keys follow the reference checkpoint, so the port's own `state_dict()`
converts back through `convert_jets_generator` unchanged. Layouts:
Dense (in, out) -> Linear (out, in); nn.Conv (K, Ci, Co) -> (Co, Ci, K);
LayerNorm scale -> weight; HiFi-GAN g, v, b are torch layout already.
The alignment module is optional (a JAX tree initialised at inference has
none); the port then keeps its own values for those keys.

`style_encoder_state_dict(params, n_layers)` does the same for the JAX
`StyleEncoder` (SimBERT): `convert_bert` / `convert_style_encoder` read
backwards, HF BERT key names.

`discriminator_state_dict(params, spectral, dcfg)` carries the JAX
`Discriminator` (`mpd_{p}` / `msd_{i}` trees and the spectral-norm `u`, `v`
collection) into the port's `Discriminator` (`convert_discriminator` read
backwards: `mpd.discriminators.{i}`, `msd.discriminators.{i}`,
`weight_orig` / `weight_u` / `weight_v` under spectral norm).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from emotivoice_tpu_torch.config import (
    AcousticConfig,
    DiscriminatorConfig,
    EmotiVoiceConfig,
    VocoderConfig,
)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


class _Out(dict):
    def dense(self, key: str, node: Mapping[str, Any]):
        self[f"{key}.weight"] = _t(np.asarray(node["kernel"]).T)
        if "bias" in node:
            self[f"{key}.bias"] = _t(node["bias"])

    def conv(self, key: str, node: Mapping[str, Any]):
        self[f"{key}.weight"] = _t(np.asarray(node["kernel"]).transpose(2, 1, 0))
        if "bias" in node:
            self[f"{key}.bias"] = _t(node["bias"])

    def ln(self, key: str, node: Mapping[str, Any]):
        self[f"{key}.weight"] = _t(node["scale"])
        self[f"{key}.bias"] = _t(node["bias"])

    def emb(self, key: str, node: Mapping[str, Any]):
        self[f"{key}.weight"] = _t(node["embedding"])

    def wn(self, key: str, node: Mapping[str, Any]):
        self[f"{key}.weight_g"] = _t(node["g"])
        self[f"{key}.weight_v"] = _t(node["v"])
        self[f"{key}.bias"] = _t(node["b"])


def _encoder(out: _Out, key: str, tree: Mapping[str, Any], n_layers: int):
    out[f"{key}.embed.0.alpha"] = _t(tree["pos_enc"]["alpha"])
    for i in range(n_layers):
        lt, lk = tree[f"layer_{i}"], f"{key}.encoders.{i}"
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            out.dense(f"{lk}.self_attn.{name}", lt["self_attn"][name])
        out.conv(f"{lk}.feed_forward.w_1", lt["feed_forward"]["w_1"]["conv"])
        out.conv(f"{lk}.feed_forward.w_2", lt["feed_forward"]["w_2"]["conv"])
        out.ln(f"{lk}.norm1", lt["norm1"])
        out.ln(f"{lk}.norm2", lt["norm2"])
    out.ln(f"{key}.after_norm", tree["after_norm"])


def _predictor(out: _Out, key: str, tree: Mapping[str, Any], n_layers: int):
    for i in range(n_layers):
        out.conv(f"{key}.conv.{i}.0", tree["conv"][f"conv_{i}"]["conv"])
        out.ln(f"{key}.conv.{i}.2", tree["conv"][f"ln_{i}"])
    out.dense(f"{key}.linear", tree["linear"])


def prompt_tts_state_dict(am: Mapping[str, Any], a: AcousticConfig,
                          prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX PromptTTS params -> port PromptTTS state dict (keys under prefix)."""
    out = _Out()
    p = prefix
    out.emb(f"{p}src_word_emb", am["src_word_emb"])
    out.emb(f"{p}spk_tokenizer", am["spk_tokenizer"])
    out.dense(f"{p}embed_projection1", am["embed_projection1"])
    _encoder(out, f"{p}encoder", am["encoder"], a.encoder_n_layers)
    _encoder(out, f"{p}decoder", am["decoder"], a.decoder_n_layers)
    _predictor(out, f"{p}duration_predictor", am["duration_predictor"], a.duration_n_layers)
    _predictor(out, f"{p}pitch_predictor", am["pitch_predictor"], a.variance_n_layers)
    _predictor(out, f"{p}energy_predictor", am["energy_predictor"], a.energy_n_layers)
    out.conv(f"{p}pitch_embed.0", am["pitch_embed"]["conv"]["conv"])
    out.conv(f"{p}energy_embed.0", am["energy_embed"]["conv"]["conv"])
    if "alignment_module" in am:
        for name in ("t_conv1", "t_conv2", "f_conv1", "f_conv2", "f_conv3"):
            out.conv(f"{p}alignment_module.{name}", am["alignment_module"][name]["conv"])
    out.dense(f"{p}to_mel", am["to_mel"])
    return dict(out)


def hifigan_state_dict(gen: Mapping[str, Any], v: VocoderConfig,
                       prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX HiFiGANGenerator params -> port generator state dict."""
    out = _Out()
    p = prefix
    out.wn(f"{p}conv_pre", gen["conv_pre"])
    out.wn(f"{p}conv_post", gen["conv_post"])
    for i in range(len(v.upsample_rates)):
        out.wn(f"{p}ups.{i}", gen[f"ups_{i}"])
    n_kernels = len(v.resblock_kernel_sizes)
    for i in range(len(v.upsample_rates) * n_kernels):
        block = gen[f"resblocks_{i}"]
        for j in range(len(v.resblock_dilation_sizes[i % n_kernels])):
            if v.resblock == "1":
                out.wn(f"{p}resblocks.{i}.convs1.{j}", block[f"convs1_{j}"])
                out.wn(f"{p}resblocks.{i}.convs2.{j}", block[f"convs2_{j}"])
            else:
                out.wn(f"{p}resblocks.{i}.convs.{j}", block[f"convs_{j}"])
    return dict(out)


def jax_to_torch_state_dict(params: Mapping[str, Any],
                            cfg: EmotiVoiceConfig) -> Dict[str, torch.Tensor]:
    if "params" in params:
        params = params["params"]
    return {
        **prompt_tts_state_dict(params["am"], cfg.am, "am."),
        **hifigan_state_dict(params["generator"], cfg.vocoder, "generator."),
    }


def style_encoder_state_dict(params: Mapping[str, Any],
                             n_layers: int = 12) -> Dict[str, torch.Tensor]:
    """JAX StyleEncoder params (`{'params': {'bert': ..., '*_clf': ...}}` or
    the inner dict) -> port `StyleEncoder` state dict."""
    if "params" in params:
        params = params["params"]
    bert = params["bert"]
    out = _Out()
    e = "bert.embeddings"
    out.emb(f"{e}.word_embeddings", bert["word_embeddings"])
    out.emb(f"{e}.position_embeddings", bert["position_embeddings"])
    out.emb(f"{e}.token_type_embeddings", bert["token_type_embeddings"])
    out.ln(f"{e}.LayerNorm", bert["embeddings_ln"])
    for i in range(n_layers):
        lt, lk = bert[f"layer_{i}"], f"bert.encoder.layer.{i}"
        for name in ("query", "key", "value"):
            out.dense(f"{lk}.attention.self.{name}", lt["attention"][name])
        out.dense(f"{lk}.attention.output.dense", lt["attention_output"])
        out.ln(f"{lk}.attention.output.LayerNorm", lt["attention_ln"])
        out.dense(f"{lk}.intermediate.dense", lt["intermediate"])
        out.dense(f"{lk}.output.dense", lt["output"])
        out.ln(f"{lk}.output.LayerNorm", lt["output_ln"])
    out.dense("bert.pooler.dense", bert["pooler"])
    for head in ("pitch_clf", "speed_clf", "energy_clf", "emotion_clf"):
        if head in params:
            out.dense(f"{head}.classifier", params[head])
    return dict(out)


def discriminator_state_dict(params: Mapping[str, Any], spectral: Mapping[str, Any],
                             dcfg: DiscriminatorConfig) -> Dict[str, torch.Tensor]:
    """JAX Discriminator params and spectral state -> port `Discriminator`
    state dict."""
    if "params" in params:
        params = params["params"]
    out = _Out()
    n_convs = len(dcfg.period_channels) + 1
    for i, p in enumerate(dcfg.periods):
        tree, key = params[f"mpd_{p}"], f"mpd.discriminators.{i}"
        for j in range(n_convs):
            out.wn(f"{key}.convs.{j}", tree[f"convs_{j}"])
        out.wn(f"{key}.conv_post", tree["conv_post"])
    names = [(f"convs_{j}", f"convs.{j}") for j in range(len(dcfg.scale_layers))]
    names.append(("conv_post", "conv_post"))
    for i in range(dcfg.n_scales):
        tree, key = params[f"msd_{i}"], f"msd.discriminators.{i}"
        for name, sub in names:
            k = f"{key}.{sub}"
            if i == 0:  # spectral norm
                out[f"{k}.weight_orig"] = _t(tree[name]["w"])
                out[f"{k}.bias"] = _t(tree[name]["b"])
                out[f"{k}.weight_u"] = _t(spectral[f"msd_{i}"][name]["u"])
                out[f"{k}.weight_v"] = _t(spectral[f"msd_{i}"][name]["v"])
            else:
                out.wn(k, tree[name])
    return dict(out)
