"""A reference module for the tests only: the released model's, with the
vocoder's last activation a leaky ReLU of slope 0.5 in place of 0.01, and a
count of the calls the harness makes into it. The program computes the
released model, so a run that names this module must come out not correct."""

import collections

import torch
import torch.nn.functional as F

from port_bench.reference import model as base
from port_bench.reference.model import (DURATION_OUT, Precision, acoustic, fixed,  # noqa: F401
                                        to_durations)

calls = collections.Counter()


def param_shapes(cfg):
    calls["param_shapes"] += 1
    return base.param_shapes(cfg)


def init(key, shape, cfg):
    calls["init"] += 1
    return base.init(key, shape, cfg)


def request_flops(cfg, n_tokens, n_frames):
    calls["request_flops"] += 1
    return base.request_flops(cfg, n_tokens, n_frames)


def vocoder(sd, cfg, mel, pr):
    """`base.vocoder` up to its last activation."""
    v = cfg["vocoder"]
    slope = v["lrelu_slope"]
    x = base._conv(mel, base._wn(sd, "generator.conv_pre"), sd["generator.conv_pre.bias"], pr, padding=3)
    nk = len(v["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(v["upsample_rates"], v["upsample_kernel_sizes"])):
        p = f"generator.ups.{i}"
        x = F.leaky_relu(x, slope)
        x = F.conv_transpose1d(pr.q(x.transpose(1, 2)), pr.q(base._wn(sd, p)), sd[f"{p}.bias"],
                               stride=u, padding=(k - u) // 2).transpose(1, 2)
        acc = None
        for j, (rk, rd) in enumerate(zip(v["resblock_kernel_sizes"], v["resblock_dilation_sizes"])):
            p = f"generator.resblocks.{i * nk + j}"
            y = x
            for n, d in enumerate(rd):
                h = base._conv(F.leaky_relu(y, slope), base._wn(sd, f"{p}.convs1.{n}"),
                               sd[f"{p}.convs1.{n}.bias"], pr, dilation=d)
                y = y + base._conv(F.leaky_relu(h, slope), base._wn(sd, f"{p}.convs2.{n}"),
                                   sd[f"{p}.convs2.{n}.bias"], pr)
            acc = y if acc is None else acc + y
        x = acc / nk
    y = base._conv(F.leaky_relu(x, 0.5), base._wn(sd, "generator.conv_post"),
                   sd["generator.conv_post.bias"], pr, padding=3)
    return torch.tanh(y)[..., 0]


@torch.no_grad()
def synthesize(sd, cfg, tokens, length, speaker, style, content, max_frames, alpha=1.0,
               durations=None, precision="f32"):
    calls["synthesize"] += 1
    pr = Precision(precision)
    with pr.flags():
        out = acoustic(sd, cfg, tokens, length, speaker, style, content, max_frames, alpha,
                       durations, pr)
        out["wav"] = vocoder(sd, cfg, out["mel"], pr)
    return out
