"""Plain PyTorch networks of the benchmark's configurations.

The momentum UNet, the ResNet3D strain head, the strain-matrix LMA network,
the joint registration + strain network and the pairwise registration
network, as the configurations state them: the convolutional trunks in
bfloat16 (float32 GroupNorm statistics), the momentum head, the dense
layers and every operator of ``ops`` in float32. Parameter names and shapes
are the program's, so one state dict loads into both. A ``Numerics`` in
control mode rounds every float32 layer's weights and results to bfloat16.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from reference.ops import (EXACT, Numerics, shoot, spectral_resize,
                           subspace_smooth, warp)

gelu = functools.partial(F.gelu, approximate="tanh")


def _same_pads(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """2-D convolution in the input's dtype, 'SAME' (XLA) or explicit
    padding, bias added after."""

    def __init__(self, c_in, c_out, kernel=(3, 3), stride=1, padding="SAME",
                 num: Numerics = EXACT):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, *kernel))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.stride, self.padding, self.num = int(stride), padding, num

    def forward(self, x):
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
        y = F.conv2d(self.num(x), self.num(self.weight).to(x.dtype),
                     stride=self.stride, padding=pad)
        return self.num(y + self.num(self.bias).to(y.dtype)[:, None, None])


class GroupNorm(nn.Module):
    """Float32 statistics over (spatial, group channels), eps 1e-6,
    bfloat16 output."""

    def __init__(self, groups, features, eps=1e-6):
        super().__init__()
        self.groups, self.eps = int(groups), float(eps)
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        n, c = x.shape[:2]
        g = self.groups
        x32 = x.float().reshape(n, g, c // g, -1)
        mu = x32.mean(dim=(2, 3), keepdim=True)
        var = ((x32 * x32).mean(dim=(2, 3), keepdim=True)
               - mu * mu).clamp_min(0.0)
        y = (x32 - mu) * (torch.rsqrt(var + self.eps)
                          * self.weight.view(1, g, c // g, 1)) \
            + self.bias.view(1, g, c // g, 1)
        return y.reshape(x.shape).to(torch.bfloat16)


class ConvBlock(nn.Module):
    def __init__(self, c_in, features, stride=1):
        super().__init__()
        self.conv = Conv(c_in, features, stride=stride)
        self.norm = GroupNorm(min(8, features), features)

    def forward(self, x):
        return gelu(self.norm(self.conv(x)))


class Dense(nn.Module):
    def __init__(self, d_in, d_out, num: Numerics = EXACT):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out))
        self.num = num

    def forward(self, x):
        y = self.num(self.num(x) @ self.num(self.weight).to(x.dtype).T)
        return self.num(y + self.num(self.bias).to(y.dtype))


class MomentumUNet(nn.Module):
    """(B, H, W, 2) pair -> momentum (B, H, W, 2): a stride-2 stem to half
    resolution, a 3-level bfloat16 UNet, a float32 head, the momentum
    resized back spectrally."""

    def __init__(self, features=16, levels=3, num: Numerics = EXACT):
        super().__init__()
        f = features
        widths = [f * 2 ** i for i in range(levels)]
        self.levels, self.num = levels, num
        self.stem = ConvBlock(2, f, stride=2)
        c = f
        self.enc, self.down = nn.ModuleList(), nn.ModuleList()
        for fl in widths:
            self.enc.append(ConvBlock(c, fl))
            self.down.append(ConvBlock(fl, fl, stride=2))
            c = fl
        fb = f * 2 ** levels
        self.mid = nn.ModuleList([ConvBlock(c, fb), ConvBlock(fb, fb)])
        self.up_conv, self.dec = nn.ModuleList(), nn.ModuleList()
        c = fb
        for fl in reversed(widths):
            self.up_conv.append(Conv(c, fl))
            self.dec.append(ConvBlock(2 * fl, fl))
            c = fl
        self.head = Conv(f, 2, num=num)

    def forward(self, x):
        h, w = x.shape[1], x.shape[2]
        if h % 2 or w % 2 or min(h, w) < 4 * 2 ** self.levels:
            raise ValueError("the half-resolution UNet needs even frames of "
                             f"at least {4 * 2 ** self.levels} px")
        x = self.stem(x.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous())
        skips = []
        for enc, down in zip(self.enc, self.down):
            x = enc(x)
            skips.append(x)
            x = down(x)
        for blk in self.mid:
            x = blk(x)
        for up, dec, skip in zip(self.up_conv, self.dec, reversed(skips)):
            x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            x = up(x)[:, :, :skip.shape[2], :skip.shape[3]]
            x = dec(torch.cat([x, skip], dim=1))
        m = spectral_resize(self.head(x.float()), (h, w), self.num)
        return m.permute(0, 2, 3, 1)


class SpatioTemporalBlock(nn.Module):
    """Stride-2 conv + GroupNorm + gelu on each frame, then the temporal
    mix z_t = W_p y_{t-1} + W_y y_t + W_n y_{t+1} + b (edge frames
    replicate) and gelu(z + y)."""

    def __init__(self, c_in, features):
        super().__init__()
        self.conv = Conv(c_in, features, stride=2)
        self.norm = GroupNorm(min(8, features), features)
        self.mix_weight = nn.Parameter(torch.empty(3 * features, features))
        self.mix_bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, t):
        y = gelu(self.norm(self.conv(x)))
        f = y.shape[1]
        mm = torch.einsum("nchw,kc->nkhw", y, self.mix_weight.to(y.dtype))
        mm = mm.reshape(-1, t, 3 * f, *mm.shape[2:])
        prev = torch.cat([mm[:, :1, :f], mm[:, :-1, :f]], dim=1)
        nxt = torch.cat([mm[:, 1:, 2 * f:], mm[:, -1:, 2 * f:]], dim=1)
        z = prev + mm[:, :, f:2 * f] + nxt \
            + self.mix_bias.to(y.dtype)[:, None, None]
        return gelu(z.reshape(y.shape) + y)


class ResNet3DStrainHead(nn.Module):
    """(B, T, H, W, 2) motion video -> (B, sectors, T_out)."""

    def __init__(self, sectors, features, in_frames, out_frames,
                 num: Numerics = EXACT):
        super().__init__()
        self.blocks = nn.ModuleList()
        c = 2
        for i in range(3):
            self.blocks.append(SpatioTemporalBlock(c, features * 2 ** i))
            c = features * 2 ** i
        self.fc = Dense(c, 4 * features, num)
        self.sector = Dense(4 * features, sectors, num)
        self.frames = Dense(in_frames, out_frames, num) \
            if out_frames != in_frames else None

    def forward(self, x):
        b, t, h, w, c = x.shape
        y = x.reshape(b * t, h, w, c).permute(0, 3, 1, 2)
        y = y.to(torch.bfloat16).contiguous()
        for blk in self.blocks:
            y = blk(y, t)
        pooled = y.mean(dim=(2, 3)).reshape(b, t, -1).float()
        strain = self.sector(gelu(self.fc(pooled))).transpose(1, 2)
        return self.frames(strain) if self.frames is not None else strain


class SectorConvBlock(nn.Module):
    def __init__(self, c_in, features):
        super().__init__()
        self.conv = Conv(c_in, features, (3, 3), padding=((0, 0), (1, 1)))
        self.norm = GroupNorm(min(8, features), features)

    def forward(self, x):
        x = torch.cat([x[:, :, -1:], x, x[:, :, :1]], dim=2)
        return gelu(self.norm(self.conv(x)))


class NetStrainMat2LMA(nn.Module):
    """Strain matrix (B, 1, S, T) -> TOS (B, S): a bfloat16 conv stack with
    circular sector padding, a per-sector dense, softplus + 1."""

    def __init__(self, layers=3, features=16, in_channels=1, frames=40,
                 num: Numerics = EXACT):
        super().__init__()
        f = features
        self.convs = nn.ModuleList(
            SectorConvBlock(in_channels if i == 0 else f, f)
            for i in range(layers))
        self.fc = Dense(frames * f, 4 * f)
        self.tos = Dense(4 * f, 1, num)
        self.num = num

    def forward(self, strain):
        x = strain.to(torch.bfloat16)
        for blk in self.convs:
            x = blk(x)
        b, c, s, t = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, s, t * c)
        feat = gelu(self.fc(x)).float()
        return {"TOS": self.num(F.softplus(self.tos(feat)[..., 0]) + 1.0)}


class JointNet(nn.Module):
    """(src, tar) (B, 1, P, H, W) -> momentum UNet a pair, shooting on the
    half grid (5 Euler steps, in-scan radius 2), the final warp of the
    source (radius 12), the strain head on the half-grid displacement video
    and the rank-5 smoothing of the strain matrix."""

    def __init__(self, cfg: Dict, n_pairs: int, num: Numerics = EXACT):
        super().__init__()
        self.alpha = float(cfg.get("alpha", 2.0))
        self.gamma = float(cfg.get("gamma", 1.0))
        self.steps = int(cfg.get("n_integration_steps", 5))
        self.rank = int(cfg.get("strainmat_smoothing_SVD_rank", 5))
        self.iters = int(cfg.get("strainmat_smoothing_iters", 4))
        self.num = num
        self.momentum_unet = MomentumUNet(16, 3, num)
        self.strain_head = ResNet3DStrainHead(
            int(cfg.get("n_sectors", 126)), 16, n_pairs,
            int(cfg.get("n_strain_matrix_frames", 40)), num)

    def forward(self, src_vol, tar_vol):
        b, _, p, h, w = src_vol.shape
        src = src_vol.reshape(b * p, 1, h, w)
        tar = tar_vol.reshape(b * p, 1, h, w)
        x = torch.cat([src, tar], dim=1).permute(0, 2, 3, 1)
        m0 = self.momentum_unet(x).permute(0, 3, 1, 2).contiguous()
        u_inv, v0, u_low = shoot(m0, self.alpha, self.gamma, 2, self.steps,
                                 8, 2, self.num)
        deformed = warp(src.detach(), u_inv, 12, self.num)
        small = u_low.reshape(b, p, 2, h // 2, w // 2).permute(0, 1, 3, 4, 2)
        strain = subspace_smooth(self.strain_head(small), self.rank,
                                 self.iters, self.num)
        return {"strain_matrix": strain[:, None],
                "deformed_source": deformed.reshape(b, 1, p, h, w),
                "velocity": v0.reshape(b, 2, p, h, w),
                "momentum": m0.reshape(b, 2, p, h, w)}


class RegistrationNet(nn.Module):
    """(src, tar) (B, 1, H, W) -> the momentum UNet, shooting on the half
    grid, the final warp of the source."""

    def __init__(self, cfg: Dict, num: Numerics = EXACT):
        super().__init__()
        self.alpha = float(cfg.get("alpha", 2.0))
        self.gamma = float(cfg.get("gamma", 1.0))
        self.steps = int(cfg.get("n_integration_steps", 5))
        self.num = num
        self.momentum_unet = MomentumUNet(int(cfg.get("features", 16)),
                                          int(cfg.get("n_levels", 3)), num)

    def forward(self, src, tar):
        x = torch.cat([src, tar], dim=1).permute(0, 2, 3, 1)
        m0 = self.momentum_unet(x).permute(0, 3, 1, 2).contiguous()
        u_inv, v0, _ = shoot(m0, self.alpha, self.gamma, 2, self.steps, 8, 2,
                             self.num)
        return {"deformed_source": warp(src.detach(), u_inv, 12, self.num),
                "velocity": v0, "momentum": m0}
