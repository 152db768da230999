"""CIFAR backbones with GroupNorm — smallcnn, ResNet18-GN, VGG11-GN
(reference ``repro.models.cnn``).

Parameters are nested dicts keyed exactly like the reference; conv weights
stay HWIO and are permuted to OIHW at the call, activations are NHWC at
every function boundary (inside a conv they are a channels-last view, so no
copy is made).  XLA's ``"SAME"`` padding is reproduced exactly: with stride
2 on an even input it pads 0 before and 1 after (16 -> 8), which
``padding=1`` would not, so those convs pad explicitly first.

``*_fwd_flops`` return per-weight-leaf forward FLOPs keyed by the same
paths (multiply-add = 2 FLOPs); they are copies of the reference.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.common import groupnorm, groupnorm_init, lecun_init
from repro_torch.utils.tree import tree_leaves

PyTree = Any


# ---------------------------------------------------------------------------
# conv helpers (NHWC, HWIO)
# ---------------------------------------------------------------------------


def conv_init(gen, kh, kw, cin, cout, device):
    return {"w": lecun_init(gen, (kh, kw, cin, cout), fan_in=kh * kw * cin,
                            device=device)}


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(params, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC x HWIO -> NHWC with XLA ``"SAME"`` padding."""
    w = params["w"]
    top, bottom = _same_pads(x.shape[1], w.shape[0], stride)
    left, right = _same_pads(x.shape[2], w.shape[1], stride)
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1)
    if (top, left) == (bottom, right):
        y = F.conv2d(xc, wc, stride=stride, padding=(top, left))
    else:
        y = F.conv2d(F.pad(xc, (left, right, top, bottom)), wc, stride=stride)
    return y.permute(0, 2, 3, 1)


def conv_flops(kh, kw, cin, cout, out_h, out_w):
    return 2.0 * kh * kw * cin * cout * out_h * out_w


def _fc_init(gen, cin, n_classes, device):
    return {"w": lecun_init(gen, (cin, n_classes), fan_in=cin, device=device),
            "b": torch.zeros(n_classes, device=device)}


def _head(params, x):
    return x.mean(dim=(1, 2)) @ params["fc"]["w"] + params["fc"]["b"]


# ---------------------------------------------------------------------------
# ResNet18-GN (CIFAR variant)
# ---------------------------------------------------------------------------

RESNET18_STAGES = [(64, 1), (128, 2), (256, 2), (512, 2)]  # (width, first stride)


def _basic_block_init(gen, cin, cout, stride, device):
    p = {
        "conv1": conv_init(gen, 3, 3, cin, cout, device),
        "gn1": groupnorm_init(cout, device),
        "conv2": conv_init(gen, 3, 3, cout, cout, device),
        "gn2": groupnorm_init(cout, device),
    }
    if stride != 1 or cin != cout:
        p["down"] = conv_init(gen, 1, 1, cin, cout, device)
        p["gn_down"] = groupnorm_init(cout, device)
    return p


def _basic_block(p, x, stride):
    y = conv(p["conv1"], x, stride)
    y = torch.relu(groupnorm(p["gn1"], y))
    y = conv(p["conv2"], y, 1)
    y = groupnorm(p["gn2"], y)
    if "down" in p:
        x = groupnorm(p["gn_down"], conv(p["down"], x, stride))
    return torch.relu(x + y)


def init_resnet18(gen: torch.Generator, num_classes: int,
                  device="cpu") -> PyTree:
    p: dict = {"stem": conv_init(gen, 3, 3, 3, 64, device),
               "gn_stem": groupnorm_init(64, device)}
    cin = 64
    for si, (w, stride) in enumerate(RESNET18_STAGES):
        for bi in range(2):
            s = stride if bi == 0 else 1
            p[f"s{si}b{bi}"] = _basic_block_init(gen, cin, w, s, device)
            cin = w
    p["fc"] = _fc_init(gen, 512, num_classes, device)
    return p


def resnet18_apply(params, images: torch.Tensor) -> torch.Tensor:
    """images: (B, H, W, 3) NHWC -> logits (B, classes)."""
    x = torch.relu(groupnorm(params["gn_stem"], conv(params["stem"], images, 1)))
    for si, (_, stride) in enumerate(RESNET18_STAGES):
        for bi in range(2):
            s = stride if bi == 0 else 1
            x = _basic_block(params[f"s{si}b{bi}"], x, s)
    return _head(params, x)


def resnet18_fwd_flops(num_classes: int, hw: int = 32) -> dict[str, float]:
    """Per-conv-leaf forward FLOPs for one (hw, hw, 3) image."""
    out: dict[str, float] = {}
    h = hw
    out["stem/w"] = conv_flops(3, 3, 3, 64, h, h)
    cin = 64
    for si, (w, stride) in enumerate(RESNET18_STAGES):
        for bi in range(2):
            s = stride if bi == 0 else 1
            h_out = h // s
            out[f"s{si}b{bi}/conv1/w"] = conv_flops(3, 3, cin, w, h_out, h_out)
            out[f"s{si}b{bi}/conv2/w"] = conv_flops(3, 3, w, w, h_out, h_out)
            if s != 1 or cin != w:
                out[f"s{si}b{bi}/down/w"] = conv_flops(1, 1, cin, w, h_out, h_out)
            cin = w
            h = h_out
    out["fc/w"] = 2.0 * 512 * num_classes
    return out


# ---------------------------------------------------------------------------
# VGG11-GN (CIFAR variant)
# ---------------------------------------------------------------------------

VGG11_CFG = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"]


def init_vgg11(gen: torch.Generator, num_classes: int, device="cpu") -> PyTree:
    p: dict = {}
    cin = 3
    i = 0
    for c in VGG11_CFG:
        if c == "M":
            continue
        p[f"conv{i}"] = conv_init(gen, 3, 3, cin, c, device)
        p[f"gn{i}"] = groupnorm_init(c, device)
        cin = c
        i += 1
    p["fc"] = _fc_init(gen, 512, num_classes, device)
    return p


def vgg11_apply(params, images: torch.Tensor) -> torch.Tensor:
    x = images
    i = 0
    for c in VGG11_CFG:
        if c == "M":
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        else:
            x = torch.relu(groupnorm(params[f"gn{i}"],
                                     conv(params[f"conv{i}"], x, 1)))
            i += 1
    return _head(params, x)


def vgg11_fwd_flops(num_classes: int, hw: int = 32) -> dict[str, float]:
    out: dict[str, float] = {}
    h = hw
    cin = 3
    i = 0
    for c in VGG11_CFG:
        if c == "M":
            h //= 2
        else:
            out[f"conv{i}/w"] = conv_flops(3, 3, cin, c, h, h)
            cin = c
            i += 1
    out["fc/w"] = 2.0 * 512 * num_classes
    return out


# ---------------------------------------------------------------------------
# Small CNN (fast experiments / tests)
# ---------------------------------------------------------------------------


def init_smallcnn(gen: torch.Generator, num_classes: int, width: int = 16,
                  in_ch: int = 3, device="cpu") -> PyTree:
    return {
        "conv0": conv_init(gen, 3, 3, in_ch, width, device),
        "gn0": groupnorm_init(width, device),
        "conv1": conv_init(gen, 3, 3, width, 2 * width, device),
        "gn1": groupnorm_init(2 * width, device),
        "conv2": conv_init(gen, 3, 3, 2 * width, 4 * width, device),
        "gn2": groupnorm_init(4 * width, device),
        "fc": _fc_init(gen, 4 * width, num_classes, device),
    }


def smallcnn_apply(params, images: torch.Tensor) -> torch.Tensor:
    x = torch.relu(groupnorm(params["gn0"], conv(params["conv0"], images, 2)))
    x = torch.relu(groupnorm(params["gn1"], conv(params["conv1"], x, 2)))
    x = torch.relu(groupnorm(params["gn2"], conv(params["conv2"], x, 2)))
    return _head(params, x)


def smallcnn_fwd_flops(num_classes: int, hw: int = 32, width: int = 16,
                       in_ch: int = 3) -> dict[str, float]:
    h = hw // 2
    out = {"conv0/w": conv_flops(3, 3, in_ch, width, h, h)}
    h //= 2
    out["conv1/w"] = conv_flops(3, 3, width, 2 * width, h, h)
    h //= 2
    out["conv2/w"] = conv_flops(3, 3, 2 * width, 4 * width, h, h)
    out["fc/w"] = 2.0 * 4 * width * num_classes
    return out


def count_params(tree: PyTree) -> int:
    return int(sum(x.numel() for x in tree_leaves(tree)))
