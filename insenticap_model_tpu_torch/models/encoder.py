"""Patched ResNet-101 feature extractor (reference models/encoder.py:9-55).

Counterpart of ``insenticap_model_tpu/models/encoder.py``. The reference
patches torchvision's ResNet-101 in two ways (encoder.py:12-15): the
maxpool is kernel 3, stride 2, padding 0, ceil_mode=True, and the stride 2
of the first block of layers 2-4 sits on conv1 (ResNet v1) rather than
conv2. Inference only: BatchNorm uses its running statistics, with the JAX
package's arithmetic (not folded into the convs).

Public layouts are the JAX package's: images and activations NHWC, conv
weights HWIO, BatchNorm nodes ``{scale, bias, mean, var}``. Inside, an NHWC
tensor permuted to NCHW is channels-last in memory, which is what cuDNN's
tensor cores take, so no layer copies its activation. The convolutions go to
``F.conv2d`` (the JAX package leaves them to XLA's
``conv_general_dilated``) under ``nn.exact_numerics()``, so f32 is not
computed in TF32. The stem's max pool is the hand-written kernel
(``ops/pool.py``) on a CUDA tensor.

``forward_batch`` / ``forward_raw_batch`` return (fc [N, 2048], att [N, 14,
14, 2048]): fc is the spatial mean of the last conv map, att its adaptive
average pool.
"""
from __future__ import annotations

import math
import os
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .. import nn
from ..ops import pool
from ..ops.adaptive_pool import adaptive_avg_pool2d
from ..utils.dtypes import resolve_device

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# ResNet-101: blocks per layer, mid-channels per layer
LAYERS = (3, 4, 23, 3)
MIDS = (64, 128, 256, 512)
EXPANSION = 4


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _conv_init(gen, kh, kw, cin, cout, dtype, device):
    """torchvision's kaiming_normal_(mode="fan_out", relu), HWIO."""
    std = math.sqrt(2.0 / (kh * kw * cout))
    w = torch.empty((kh, kw, cin, cout), dtype=torch.float32).normal_(
        generator=gen) * std
    return {"weight": w.to(device=device, dtype=dtype)}


def _bn_init(c, dtype, device):
    """BatchNorm at identity: scale 1, bias 0, mean 0, var 1."""
    def full(v):
        return torch.full((c,), v, dtype=dtype, device=device)
    return {"scale": full(1.0), "bias": full(0.0), "mean": full(0.0),
            "var": full(1.0)}


def init_params(gen: torch.Generator, *, device="cuda",
                dtype=torch.float32) -> Dict:
    """Weights from a seed (real use converts resnet101.pth with
    ``convert_torch_state_dict``)."""
    dev = resolve_device(device)
    kw = {"dtype": dtype, "device": dev}
    p: Dict = {"conv1": _conv_init(gen, 7, 7, 3, 64, **kw),
               "bn1": _bn_init(64, **kw), "layers": []}
    cin = 64
    for li, (nblocks, mid) in enumerate(zip(LAYERS, MIDS)):
        layer: List[Dict] = []
        cout = mid * EXPANSION
        for b in range(nblocks):
            blk = {"conv1": _conv_init(gen, 1, 1, cin, mid, **kw),
                   "bn1": _bn_init(mid, **kw),
                   "conv2": _conv_init(gen, 3, 3, mid, mid, **kw),
                   "bn2": _bn_init(mid, **kw),
                   "conv3": _conv_init(gen, 1, 1, mid, cout, **kw),
                   "bn3": _bn_init(cout, **kw)}
            if b == 0 and (li > 0 or cin != cout):
                blk["downsample"] = {
                    "conv": _conv_init(gen, 1, 1, cin, cout, **kw),
                    "bn": _bn_init(cout, **kw)}
            layer.append(blk)
            cin = cout
        p["layers"].append(layer)
    return p


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _bn(p, x, eps=1e-5):
    """The JAX package's arithmetic (encoder.py:88-90), in x's dtype."""
    inv = torch.rsqrt(p["var"] + eps)
    return (x - p["mean"]) * inv * p["scale"] + p["bias"]


def _conv(p, x, stride: int, pad: int):
    """NHWC x, HWIO weight -> NHWC."""
    with nn.exact_numerics():
        out = F.conv2d(x.permute(0, 3, 1, 2),
                       p["weight"].permute(3, 2, 0, 1), stride=stride,
                       padding=pad)
    return out.permute(0, 2, 3, 1)


def _s2d_kernel(w):
    """conv1's [7,7,cin,cout] kernel re-indexed for space-to-depth pixels:
    w2[ki,kj,(a*2+b)*cin+c] = w[2ki+a, 2kj+b, c] (zero where 2k+a > 6)."""
    kh, kw, cin, cout = w.shape
    wp = F.pad(w, (0, 0, 0, 0, 0, 8 - kw, 0, 8 - kh))
    return wp.reshape(4, 2, 4, 2, cin, cout).permute(0, 2, 1, 3, 4, 5) \
        .reshape(4, 4, 4 * cin, cout)


def _stem_conv_s2d(w7, x):
    """The stem's 7x7/stride-2/pad-3 conv as a 4x4/stride-1 VALID conv over
    space-to-depth pixels (the JAX package's ``_stem_conv_s2d``,
    encoder.py:112-129): the same products, another tiling. Needs even H,
    W."""
    B, H, W, C = x.shape
    xp = F.pad(x, (0, 0, 3, 3, 3, 3))
    hq, wq = (H + 6) // 2, (W + 6) // 2
    x2 = xp.reshape(B, hq, 2, wq, 2, C).permute(0, 1, 3, 2, 4, 5) \
        .reshape(B, hq, wq, 4 * C)
    out = _conv({"weight": _s2d_kernel(w7)}, x2, 1, 0)
    return out[:, :H // 2, :W // 2]


def _ceil_maxpool_3x3s2(x, use_kernels: bool = True):
    """MaxPool2d(3, stride 2, padding 0, ceil_mode=True) (reference
    encoder.py:12): the kernel on a CUDA tensor, the plain version on the
    CPU or with ``use_kernels=False``."""
    if use_kernels:
        return pool.ceil_maxpool_3x3s2_nhwc(x)
    return pool.ceil_maxpool_3x3s2_plain(x)


def _bottleneck(p, x, stride: int):
    """The stride sits on conv1 (the reference's patch, encoder.py:14-15)."""
    out = torch.relu(_bn(p["bn1"], _conv(p["conv1"], x, stride, 0)))
    out = torch.relu(_bn(p["bn2"], _conv(p["conv2"], out, 1, 1)))
    out = _bn(p["bn3"], _conv(p["conv3"], out, 1, 0))
    if "downsample" in p:
        x = _bn(p["downsample"]["bn"],
                _conv(p["downsample"]["conv"], x, stride, 0))
    return torch.relu(out + x)


def _trunk(params, x, att_size: int, use_kernels: bool):
    """Everything after conv1 + bn1 + relu: the max pool, the four layers,
    the fc and att heads."""
    x = _ceil_maxpool_3x3s2(x, use_kernels)
    for li, layer in enumerate(params["layers"]):
        for b, blk in enumerate(layer):
            x = _bottleneck(blk, x, 2 if (li > 0 and b == 0) else 1)
    fc = x.mean(dim=(1, 2))                                      # [N, 2048]
    att = adaptive_avg_pool2d(x, (att_size, att_size))           # [N,a,a,C]
    return fc, att


def forward_batch(params, imgs, att_size: int = 14, *,
                  use_kernels: bool = True):
    """imgs [N, H, W, 3] normalized float (one H, W per batch). Returns
    (fc [N, 2048], att [N, att_size, att_size, 2048]) in the params'
    dtype."""
    x = imgs.to(params["conv1"]["weight"].dtype)
    x = torch.relu(_bn(params["bn1"], _conv(params["conv1"], x, 2, 3)))
    return _trunk(params, x, att_size, use_kernels)


def forward_raw_batch(params, imgs, att_size: int = 14,
                      s2d_stem: bool = None, *, use_kernels: bool = True):
    """Raw uint8 batches (imgs [N, H, W, 3] uint8 on the params' device):
    the ImageNet normalisation x' = x / (255 std) - mean / std = a x + b is
    per-channel affine and conv1 is linear, so it folds into conv1 (the JAX
    package's ``forward_raw_batch``, encoder.py:178-218): the scale a enters
    the weights; the offset b becomes a spatial map, conv1 with the
    unscaled weights over a constant image b (constant inside, tapering in
    the 3-pixel pad band), which the JAX package constant-folds and which
    costs one bs=1 conv here. Everything runs in the params' dtype (uint8
    pixel values are exact in bf16).

    ``s2d_stem`` (None: ``ISC_S2D_STEM=1`` in the environment, read at each
    call, off by default) runs conv1 as the space-to-depth rewrite when H
    and W are even."""
    if s2d_stem is None:
        s2d_stem = os.environ.get("ISC_S2D_STEM", "0") == "1"
    w = params["conv1"]["weight"]
    x = imgs.to(w.dtype)
    a = torch.as_tensor(1.0 / (255.0 * IMAGENET_STD)).to(w.device, w.dtype)
    b = torch.as_tensor(-IMAGENET_MEAN / IMAGENET_STD).to(w.device, w.dtype)
    w_folded = {"weight": w * a[None, None, :, None]}
    H, W = x.shape[1], x.shape[2]
    if s2d_stem and H % 2 == 0 and W % 2 == 0:
        xc = _stem_conv_s2d(w_folded["weight"], x)
    else:
        xc = _conv(w_folded, x, 2, 3)
    offset_map = _conv(params["conv1"], b.expand(1, H, W, 3), 2, 3)
    x = torch.relu(_bn(params["bn1"], xc + offset_map))
    return _trunk(params, x, att_size, use_kernels)


def forward(params, img, att_size: int = 14, *, use_kernels: bool = True):
    """img [H, W, 3] normalized float (see ``preprocess``). Returns
    (fc [2048], att [att_size, att_size, 2048])."""
    fc, att = forward_batch(params, img[None], att_size,
                            use_kernels=use_kernels)
    return fc[0], att[0]


# ---------------------------------------------------------------------------
# Host-side image helpers (numpy, as in the JAX package)
# ---------------------------------------------------------------------------

def to_rgb_uint8(image: np.ndarray) -> np.ndarray:
    """gray -> RGB and alpha dropped, staying uint8 (reference
    encoder.py:29-33)."""
    if image.ndim == 2:
        image = np.stack([image] * 3, axis=-1)
    if image.shape[-1] == 1:          # HxWx1 grayscale from other decoders
        image = np.repeat(image, 3, axis=-1)
    if image.shape[-1] == 4:
        image = image[..., :3]
    if image.ndim != 3 or image.shape[-1] != 3:
        raise ValueError(
            f"expected an HxW / HxWx{{1,3,4}} image, got shape "
            f"{image.shape}: other modes (palette, LA, CMYK) must be "
            f"decoded to RGB first")
    return np.ascontiguousarray(image)


def preprocess(image: np.ndarray) -> np.ndarray:
    """gray -> RGB, /255, ImageNet normalisation (reference
    encoder.py:29-37). HxW or HxWx{1,3,4} uint8 in, HxWx3 float32 out (HWC,
    the JAX package's layout)."""
    x = to_rgb_uint8(image).astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


# ---------------------------------------------------------------------------
# Weight conversion from a torchvision ResNet-101 state dict
# ---------------------------------------------------------------------------

def convert_torch_state_dict(sd, *, device="cuda") -> Dict:
    """A torchvision ResNet-101 state dict (tensors or numpy arrays, as the
    reference loads resnet101.pth, encoder.py:21-23) -> this module's f32
    params: conv weights [out, in, kh, kw] -> HWIO, BatchNorm weight / bias
    / running_mean / running_var -> scale / bias / mean / var."""
    dev = resolve_device(device)

    def arr(name):
        v = sd[name]
        t = v.detach().float() if torch.is_tensor(v) else \
            torch.from_numpy(np.array(v, np.float32))
        return t.to(dev)

    def conv(name):
        return {"weight": arr(name + ".weight").permute(2, 3, 1, 0)
                .contiguous()}

    def bn(name):
        return {"scale": arr(name + ".weight"), "bias": arr(name + ".bias"),
                "mean": arr(name + ".running_mean"),
                "var": arr(name + ".running_var")}

    p: Dict = {"conv1": conv("conv1"), "bn1": bn("bn1"), "layers": []}
    for li, nblocks in enumerate(LAYERS):
        layer = []
        for b in range(nblocks):
            base = f"layer{li + 1}.{b}"
            blk = {"conv1": conv(base + ".conv1"), "bn1": bn(base + ".bn1"),
                   "conv2": conv(base + ".conv2"), "bn2": bn(base + ".bn2"),
                   "conv3": conv(base + ".conv3"), "bn3": bn(base + ".bn3")}
            if f"{base}.downsample.0.weight" in sd:
                blk["downsample"] = {"conv": conv(base + ".downsample.0"),
                                     "bn": bn(base + ".downsample.1")}
            layer.append(blk)
        p["layers"].append(layer)
    return p
