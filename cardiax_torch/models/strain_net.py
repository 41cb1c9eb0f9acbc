"""Strain head: motion video -> (n_sectors, T_out) strain matrix.

Counterpart of ``cardiax/models/strain_net.py`` (``SpatioTemporalBlock`` with
``tmix='shiftflat'``, ``ResNet3DStrainHead`` and
``NetDisplacement2StrainMat``, the head on a (B, 2, H, W, T) displacement
video). Each block is a folded-2D
stride-2 spatial conv + GroupNorm + gelu, then the temporal (3,1,1) mix

    z_t = W_p y_{t-1} + W_y y_t + W_n y_{t+1} + b   (edge frames replicate)

as one C -> 3F channel matmul and frame shifts, and a residual gelu(z + y).
The trunk is bfloat16 (cast as ``strain_net.py:150``); the pooled features
and the dense heads are float32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from cardiax_torch.models.layers import Conv, Dense, GroupNorm, gelu


class SpatioTemporalBlock(nn.Module):
    """(B*T, C, H, W) -> (B*T, F, H/s, W/s); ``t`` frames per item.

    ``mix_weight`` (3F, F) is the (out, in) matrix of the C -> 3F product:
    rows [k*F:(k+1)*F] are W_k^T for k = previous, same, next frame."""

    def __init__(self, c_in: int, features: int, spatial_stride: int = 1):
        super().__init__()
        f = features
        self.conv = Conv(c_in, f, stride=spatial_stride)
        self.norm = GroupNorm(min(8, f), f)
        self.mix_weight = nn.Parameter(torch.empty(3 * f, f))
        self.mix_bias = nn.Parameter(torch.zeros(f))

    def forward(self, x: torch.Tensor, t: int) -> torch.Tensor:
        y = gelu(self.norm(self.conv(x)))
        f = y.shape[1]
        mm = torch.einsum("nchw,kc->nkhw", y, self.mix_weight.to(y.dtype))
        mm = mm.reshape(-1, t, 3 * f, *mm.shape[2:])
        m_p, m_y, m_n = mm[:, :, :f], mm[:, :, f:2 * f], mm[:, :, 2 * f:]
        sh_p = torch.cat([m_p[:, :1], m_p[:, :-1]], dim=1)
        sh_n = torch.cat([m_n[:, 1:], m_n[:, -1:]], dim=1)
        z = sh_p + m_y + sh_n + self.mix_bias.to(y.dtype)[:, None, None]
        return gelu(z.reshape(y.shape) + y)


class ResNet3DStrainHead(nn.Module):
    """Motion video (B, T, H, W, C) -> strain matrix (B, n_sectors, T_out)."""

    def __init__(self, n_sectors: int = 126, features: int = 16,
                 n_blocks: int = 3, in_frames: Optional[int] = None,
                 out_frames: Optional[int] = None):
        """``in_frames``: frames T of the input video; a learned
        (T -> out_frames) projection is built when ``out_frames`` differs."""
        super().__init__()
        self.blocks = nn.ModuleList()
        c = 2                                    # input channels: dy, dx
        for i in range(n_blocks):
            self.blocks.append(SpatioTemporalBlock(c, features * 2 ** i,
                                                   spatial_stride=2))
            c = features * 2 ** i
        self.fc = Dense(c, 4 * features)
        self.sector = Dense(4 * features, n_sectors)
        # the (T_pairs -> T_strain) frame projection exists only where the
        # two differ (as in JAX, where it is created at first call)
        self.frames = Dense(in_frames, out_frames) \
            if out_frames is not None and out_frames != in_frames else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        y = x.reshape(b * t, h, w, c).permute(0, 3, 1, 2)
        y = y.to(torch.bfloat16).contiguous()
        for blk in self.blocks:
            y = blk(y, t)
        pooled = y.mean(dim=(2, 3)).reshape(b, t, -1).float()  # (B, T, C)
        strain = self.sector(gelu(self.fc(pooled)))              # (B, T, S)
        strain = strain.transpose(1, 2)                          # (B, S, T)
        if self.frames is not None:
            strain = self.frames(strain)
        return strain


class NetDisplacement2StrainMat(nn.Module):
    """disp (B, 2, H, W, T) -> {'strainmat': (B, n_sectors, T)}: the strain
    head on the (B, T, H, W, 2) video, with no frame projection."""

    def __init__(self, n_sectors: int = 126, features: int = 16):
        super().__init__()
        self.strain_head = ResNet3DStrainHead(n_sectors, features)

    def forward(self, disp: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"strainmat": self.strain_head(disp.permute(0, 4, 2, 3, 1))}
