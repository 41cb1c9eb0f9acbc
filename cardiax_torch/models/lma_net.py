"""LMA head: strain matrix -> TOS per sector.

Counterpart of ``cardiax/models/lma_net.py:NetStrainMat2LMA`` with the
``TOS_regression`` task: a bfloat16 conv stack over the (sectors, frames)
plane with CIRCULAR sector padding (``lma_net.py:32-36``), a per-sector
dense over frames x channels, and TOS = softplus(dense) + 1 in float32.
The classification tasks are not ported yet.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from cardiax_torch.models.layers import Conv, Dense, GroupNorm, gelu


class SectorConvBlock(nn.Module):
    """Conv over (sectors, frames), sectors padded circularly, + GroupNorm
    + gelu."""

    def __init__(self, c_in: int, features: int, kernel=(3, 3)):
        super().__init__()
        self.pad_s = kernel[0] // 2
        self.conv = Conv(c_in, features, kernel,
                         padding=((0, 0), (kernel[1] // 2,) * 2))
        self.norm = GroupNorm(min(8, features), features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.pad_s
        if p:
            x = torch.cat([x[:, :, -p:], x, x[:, :, :p]], dim=2)
        return gelu(self.norm(self.conv(x)))


class NetStrainMat2LMA(nn.Module):
    def __init__(self, LMA_task: str = "TOS_regression",
                 num_conv_layers: int = 3, inner_conv_channel_num: int = 16,
                 input_channel_num: int = 1, n_frames: int = 40,
                 n_sectors: int = 126, n_classes: int = 1):
        super().__init__()
        if LMA_task != "TOS_regression":
            raise NotImplementedError(
                f"NetStrainMat2LMA: LMA_task {LMA_task!r} is not ported yet")
        f = inner_conv_channel_num
        self.convs = nn.ModuleList(
            SectorConvBlock(input_channel_num if i == 0 else f, f)
            for i in range(num_conv_layers))
        self.fc = Dense(n_frames * f, 4 * f)
        self.tos = Dense(4 * f, 1)

    def forward(self, strain_matrix: torch.Tensor) -> Dict[str, torch.Tensor]:
        """strain_matrix (B, C, S, T) -> {'TOS': (B, S)}."""
        x = strain_matrix.to(torch.bfloat16)
        for blk in self.convs:
            x = blk(x)
        b, c, s, t = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, s, t * c)   # (B, S, T*C)
        feat = gelu(self.fc(x)).float()
        tos = self.tos(feat)[..., 0]
        return {"TOS": F.softplus(tos) + 1.0}
