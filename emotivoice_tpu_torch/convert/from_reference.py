"""Reference PyTorch checkpoints -> the port's modules.

The port keeps the reference's parameter names, so a checkpoint needs only
unwrapping, not conversion (layouts handled: see
`emotivoice_tpu/convert/from_torch.py`):
  - ``g_{step:08d}``: {"generator": state_dict}, keys ``am.*`` and
    ``generator.*`` -> `JETSGenerator`;
  - ``do_{step:08d}``: {"discriminator": state_dict, "optim_g", "optim_d",
    ...} -> `Discriminator` (spectral-norm `weight_orig` / `weight_u` /
    `weight_v` as they are; a checkpoint without u, v keeps the module's);
  - ``checkpoint_163431``: {"model": state_dict} with DataParallel
    ``module.`` prefixes -> `StyleEncoder`.
Weight-normed convs are accepted under the parametrize naming
(`parametrizations.weight.original0/1`), the legacy one
(`weight_g`/`weight_v`) or already folded (`weight`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch
from torch import nn


def load_checkpoint(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def strip_module_prefix(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Remove DataParallel 'module.' prefixes."""
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}


def _load(model: nn.Module, sd: Mapping[str, torch.Tensor], what: str) -> nn.Module:
    # Keys the module does not have (buffers such as HF's `position_ids`)
    # are ignored; every parameter of the module must be in the checkpoint.
    missing, _ = model.load_state_dict(sd, strict=False)
    if missing:
        raise KeyError(f"{what} checkpoint lacks {sorted(missing)[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}")
    return model


def _weight_norm_names(model: nn.Module, sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Weight-norm keys of any of the three namings -> weight_g / weight_v."""
    wanted = model.state_dict().keys()
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        k = k.replace(".parametrizations.weight.original0", ".weight_g")
        k = k.replace(".parametrizations.weight.original1", ".weight_v")
        if k.endswith(".weight") and k not in wanted and f"{k}_v" in wanted:
            # folded weight: direction = the weight, gain = its norm
            out[f"{k}_v"] = v
            out[f"{k}_g"] = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())),
                                                 keepdim=True))
        else:
            out[k] = v
    return out


def load_jets_generator(model: nn.Module, ckpt: Mapping[str, Any]) -> nn.Module:
    """Load a ``g_*`` checkpoint (or its bare state dict) into a port
    `JETSGenerator`, in place."""
    sd = strip_module_prefix(ckpt["generator"] if "generator" in ckpt else ckpt)
    return _load(model, _weight_norm_names(model, sd), "generator")


def load_discriminator(model: nn.Module, ckpt: Mapping[str, Any]) -> nn.Module:
    """Load a ``do_*`` checkpoint (or its bare state dict) into a port
    `Discriminator`, in place. Spectral-norm u, v the checkpoint lacks keep
    the module's values (power iteration re-estimates them)."""
    sd = strip_module_prefix(ckpt["discriminator"] if "discriminator" in ckpt else ckpt)
    own = model.state_dict()
    # a plain `weight` under spectral norm is its weight_orig
    sd = {f"{k}_orig" if f"{k}_orig" in own else k: v for k, v in sd.items()}
    out = _weight_norm_names(model, sd)
    for k in own:
        if k.endswith((".weight_u", ".weight_v")) and k not in out and k[:-2] + "_orig" in own:
            out[k] = own[k]
    return _load(model, out, "discriminator")


def load_style_encoder(model: nn.Module, ckpt: Mapping[str, Any]) -> nn.Module:
    """Load a style-encoder checkpoint (or its bare state dict) into a port
    `StyleEncoder`, in place."""
    sd = strip_module_prefix(ckpt["model"] if "model" in ckpt else ckpt)
    return _load(model, sd, "style-encoder")
