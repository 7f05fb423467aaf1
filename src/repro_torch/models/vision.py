"""ResNet-18 in PyTorch — the paper's own testbed (CIFAR-class inputs,
BatchNorm with running stats).

The reference's layouts hold at every public function: images and
activations are NHWC, conv kernels HWIO, so params (and slab rows) match
the reference element for element. Inside, ``conv`` permutes to
NCHW/OIHW views (NHWC memory is channels_last, so no copy is made).

Two numerics follow the reference rather than torch's habits:
  * "SAME" padding as JAX computes it: a stride-2 3x3 conv over an even
    size pads (0, 1), not (1, 1), so asymmetric pads go through ``F.pad``;
  * BatchNorm in f32 with the *biased* batch variance, momentum weighting
    the OLD running value (``F.batch_norm`` uses the unbiased variance and
    the opposite momentum convention).

API: ``vision_init(gen, cfg, device) -> (params, state)``;
``vision_apply(params, state, images, train, cfg) -> (logits, new_state)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.nn.module import param


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    name: str                       # "resnet18" ("efficientnet_b0" not yet)
    num_classes: int = 10
    stem_stride: int = 1            # 1 for CIFAR 32x32, 2 for 224x224
    bn_momentum: float = 0.9
    compute_dtype: Any = torch.float32
    family: str = "vision"


# ------------------------------------------------------------ primitives ---
def conv_init(gen, kh, kw, cin, cout, device="cpu", groups=1):
    fan_in = kh * kw * cin // groups
    return {"kernel": param(gen, (kh, kw, cin // groups, cout), "normal",
                            math.sqrt(2.0 / fan_in), device)}


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """JAX/XLA "SAME" padding: output ceil(size/stride), the odd pad
    element goes to the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(p, x, stride: int = 1, groups: int = 1):
    """NHWC ``x`` by an HWIO kernel with "SAME" padding -> NHWC."""
    w = p["kernel"].to(x.dtype).permute(3, 2, 0, 1)         # OIHW
    kh, kw = w.shape[2], w.shape[3]
    xc = x.permute(0, 3, 1, 2)                               # NCHW view
    top, bot = _same_pads(x.shape[1], kh, stride)
    left, right = _same_pads(x.shape[2], kw, stride)
    if top == bot and left == right:
        y = F.conv2d(xc, w, stride=stride, padding=(top, left),
                     groups=groups)
    else:
        y = F.conv2d(F.pad(xc, (left, right, top, bot)), w, stride=stride,
                     groups=groups)
    return y.permute(0, 2, 3, 1)


def bn_init(c: int, device="cpu"):
    f32 = torch.float32
    return ({"scale": torch.ones((c,), dtype=f32, device=device),
             "bias": torch.zeros((c,), dtype=f32, device=device)},
            {"mean": torch.zeros((c,), dtype=f32, device=device),
             "var": torch.ones((c,), dtype=f32, device=device)})


def bn_apply(p, s, x, train: bool, momentum: float):
    """BatchNorm over the N, H, W axes of an NHWC tensor, in f32. Train
    mode normalizes by the batch statistics and returns running stats
    updated as ``momentum * old + (1 - momentum) * batch`` (biased
    variance); eval mode uses the running stats and returns them as is."""
    xf = x.float()
    if train:
        mu = xf.mean(dim=(0, 1, 2))
        d = xf - mu
        var = (d * d).mean(dim=(0, 1, 2))
        new_s = {"mean": (momentum * s["mean"]
                          + (1 - momentum) * mu).detach(),
                 "var": (momentum * s["var"]
                         + (1 - momentum) * var).detach()}
    else:
        mu, var = s["mean"], s["var"]
        new_s = s
    inv = torch.rsqrt(var + 1e-5)
    y = (xf - mu) * inv * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype), new_s


# --------------------------------------------------------------- ResNet ----
_RESNET18_STAGES = [(64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)]


def _basic_block_init(gen, cin, cout, stride, device="cpu"):
    p: Dict[str, Any] = {}
    st: Dict[str, Any] = {}
    p["conv1"] = conv_init(gen, 3, 3, cin, cout, device)
    p["bn1"], st["bn1"] = bn_init(cout, device)
    p["conv2"] = conv_init(gen, 3, 3, cout, cout, device)
    p["bn2"], st["bn2"] = bn_init(cout, device)
    if stride != 1 or cin != cout:
        p["proj"] = conv_init(gen, 1, 1, cin, cout, device)
        p["bnp"], st["bnp"] = bn_init(cout, device)
    return p, st


def _basic_block(p, s, x, stride, train, mom):
    ns = {}
    h, ns["bn1"] = bn_apply(p["bn1"], s["bn1"], conv(p["conv1"], x, stride),
                            train, mom)
    h = torch.relu(h)
    h, ns["bn2"] = bn_apply(p["bn2"], s["bn2"], conv(p["conv2"], h), train,
                            mom)
    if "proj" in p:
        x, ns["bnp"] = bn_apply(p["bnp"], s["bnp"],
                                conv(p["proj"], x, stride), train, mom)
    return torch.relu(h + x), ns


def resnet18_init(gen: torch.Generator, cfg: VisionConfig, device="cpu"):
    p: Dict[str, Any] = {"stem": conv_init(gen, 3, 3, 3, 64, device)}
    s: Dict[str, Any] = {}
    p["bn_stem"], s["bn_stem"] = bn_init(64, device)
    cin = 64
    for si, (cout, nblocks, stride) in enumerate(_RESNET18_STAGES):
        for bi in range(nblocks):
            st = stride if bi == 0 else 1
            p[f"s{si}b{bi}"], s[f"s{si}b{bi}"] = _basic_block_init(
                gen, cin, cout, st, device)
            cin = cout
    p["fc"] = {"kernel": param(gen, (512, cfg.num_classes), "normal",
                               1.0 / math.sqrt(512), device),
               "bias": param(gen, (cfg.num_classes,), "zeros",
                             device=device)}
    return p, s


def resnet18_apply(p, s, x, train, cfg: VisionConfig):
    mom = cfg.bn_momentum
    ns: Dict[str, Any] = {}
    h, ns["bn_stem"] = bn_apply(p["bn_stem"], s["bn_stem"],
                                conv(p["stem"], x, cfg.stem_stride), train,
                                mom)
    h = torch.relu(h)
    for si, (cout, nblocks, stride) in enumerate(_RESNET18_STAGES):
        for bi in range(nblocks):
            st = stride if bi == 0 else 1
            h, ns[f"s{si}b{bi}"] = _basic_block(
                p[f"s{si}b{bi}"], s[f"s{si}b{bi}"], h, st, train, mom)
    h = h.mean(dim=(1, 2))
    logits = h @ p["fc"]["kernel"].to(h.dtype) + p["fc"]["bias"].to(h.dtype)
    return logits, ns


def _not_ported(name: str):
    return NotImplementedError(
        f"vision model {name!r} is not ported yet (ROADMAP A5: only "
        "resnet18 runs on the PyTorch port)")


def vision_init(gen: torch.Generator, cfg: VisionConfig, device="cpu"):
    if cfg.name == "resnet18":
        return resnet18_init(gen, cfg, device)
    raise _not_ported(cfg.name)


def vision_apply(params, state, images, train, cfg: VisionConfig):
    if cfg.name == "resnet18":
        return resnet18_apply(params, state, images, train, cfg)
    raise _not_ported(cfg.name)
