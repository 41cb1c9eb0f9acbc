"""Layers shared by the port's networks, with flax's numerics.

Counterparts: ``flax.linen.Conv`` / ``cardiax/models/unet.py:PackedConv``
(groups=1), ``flax.linen.GroupNorm`` / ``unet.PackedConvBlock``'s norm,
``flax.linen.Dense`` and ``flax.linen.gelu``. Activations are NCHW inside the
port; parameters keep PyTorch's layouts (OIHW convs, (out, in) dense).
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# flax nn.gelu is the tanh approximation
gelu = functools.partial(F.gelu, approximate="tanh")


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA 'SAME' padding of one axis: a stride-2 3-tap conv on an even
    axis pads (0, 1), not (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """2-D convolution computed in the input's dtype (weights cast to it),
    bias added after the convolution in that dtype, as flax does.

    ``padding``: "SAME" or explicit ((top, bottom), (left, right))."""

    def __init__(self, c_in: int, c_out: int, kernel: Sequence[int] = (3, 3),
                 stride: int = 1, padding="SAME"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, *kernel))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.stride = int(stride)
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.weight.shape[-2:]
        if self.padding == "SAME":
            (pt, pb), (pl, pr) = (_same_pads(x.shape[-2], kh, self.stride),
                                  _same_pads(x.shape[-1], kw, self.stride))
        else:
            (pt, pb), (pl, pr) = self.padding
        if (pt, pl) == (pb, pr):
            pad = (pt, pl)
        else:
            x = F.pad(x, (pl, pr, pt, pb))
            pad = (0, 0)
        y = F.conv2d(x, self.weight.to(x.dtype), stride=self.stride,
                     padding=pad)
        return y + self.bias.to(y.dtype)[:, None, None]


class GroupNorm(nn.Module):
    """flax GroupNorm with ``dtype=bfloat16``: float32 fast-variance
    statistics over (spatial, group channels), eps 1e-6, bf16 output."""

    def __init__(self, num_groups: int, features: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups = int(num_groups)
        self.eps = float(eps)
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        g = self.num_groups
        x32 = x.float().reshape(n, g, c // g, -1)
        mu = x32.mean(dim=(2, 3), keepdim=True)
        mu2 = (x32 * x32).mean(dim=(2, 3), keepdim=True)
        var = (mu2 - mu * mu).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.view(1, g, c // g, 1)
        out = (x32 - mu) * mul + self.bias.view(1, g, c // g, 1)
        return out.reshape(x.shape).to(torch.bfloat16)


class ConvBlock(nn.Module):
    """conv + GroupNorm(min(8, F)) + gelu (``unet.PackedConvBlock``)."""

    def __init__(self, c_in: int, features: int, stride: int = 1):
        super().__init__()
        self.conv = Conv(c_in, features, stride=stride)
        self.norm = GroupNorm(min(8, features), features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(self.norm(self.conv(x)))


class Dense(nn.Module):
    """flax Dense: y = x @ W^T + b in the input's dtype, bias added after."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.weight.to(x.dtype).T
        return y + self.bias.to(y.dtype)


# flax variance_scaling(1, "fan_in", "truncated_normal"): a normal cut at
# +-2 sigma, rescaled so the cut distribution has variance 1/fan_in
_TRUNC_STD = .87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal``: truncated normal with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)
