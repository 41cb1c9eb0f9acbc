"""LMA networks: strain matrix or displacement video -> TOS / LMA labels.

Counterparts of ``cardiax/models/lma_net.py``. Each takes one of three
tasks:

    TOS_regression             -> {'TOS': (B, S)}
    LMA_sector_classification  -> {'sector_LMA_labels': (B, 2, S)} logits
    LMA_slice_classification   -> {'slice_LMA_label': (B, 2)} logits

``NetStrainMat2LMA``: a bfloat16 conv stack over the (sectors, frames)
plane with CIRCULAR sector padding (``lma_net.py:32-36``), a per-sector
dense over frames x channels, then in float32 TOS = softplus(dense) + 1, a
per-sector Dense(2), or the mean over sectors and a Dense(2).
``NetDisplacement2LMA``: three stride-2 ``SpatioTemporalBlock``s over the
(B, 2, H, W, T) (or (B, 2, T, H, W)) video in bfloat16, the mean over time
of the features flattened in flax's (h, w, c) order, Dense(8F) + gelu in
float32 and the task's head. Both have 2 classes whatever ``n_classes``
says, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cardiax_torch.models.layers import Conv, Dense, GroupNorm, gelu
from cardiax_torch.models.strain_net import SpatioTemporalBlock

_TASKS = ("TOS_regression", "LMA_sector_classification",
          "LMA_slice_classification")


def _check_task(task: str) -> None:
    if task not in _TASKS:
        raise ValueError(f"Unknown LMA_task: {task}")


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
        _check_task(LMA_task)
        self.task = LMA_task
        f = inner_conv_channel_num
        self.convs = nn.ModuleList(
            SectorConvBlock(input_channel_num if i == 0 else f, f)
            for i in range(num_conv_layers))
        self.fc = Dense(n_frames * f, 4 * f)
        # ``tos`` keeps the name of the TOS-only port's saved files
        if LMA_task == "TOS_regression":
            self.tos = Dense(4 * f, 1)
        else:
            self.head = Dense(4 * f, 2)

    def forward(self, strain_matrix: torch.Tensor) -> Dict[str, torch.Tensor]:
        """strain_matrix (B, C, S, T) -> the task's output."""
        x = strain_matrix.to(torch.bfloat16)
        for blk in self.convs:
            x = blk(x)
        b, c, s, t = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, s, t * c)   # (B, S, T*C)
        feat = gelu(self.fc(x)).float()
        if self.task == "TOS_regression":
            return {"TOS": F.softplus(self.tos(feat)[..., 0]) + 1.0}
        if self.task == "LMA_sector_classification":
            return {"sector_LMA_labels": self.head(feat).transpose(1, 2)}
        return {"slice_LMA_label": self.head(feat.mean(dim=1))}


class NetDisplacement2LMA(nn.Module):
    """Displacement video -> the LMA task's output. PyTorch sizes the
    first dense at construction, so the net takes the video's
    ``frame_size`` (H, W), which flax infers at its first call."""

    def __init__(self, LMA_task: str = "TOS_regression",
                 n_sectors: int = 126, features: int = 16,
                 num_conv_layers: int = 3, time_axis_last: bool = True,
                 frame_size: Optional[Tuple[int, int]] = None):
        super().__init__()
        _check_task(LMA_task)
        if frame_size is None:
            raise ValueError("NetDisplacement2LMA needs frame_size (H, W) "
                             "to size its dense layer")
        self.task = LMA_task
        self.n_sectors = n_sectors
        self.time_axis_last = time_axis_last
        h, w = frame_size
        self.blocks = nn.ModuleList()
        c = 2                                     # input channels: X, Y
        for i in range(num_conv_layers):
            self.blocks.append(SpatioTemporalBlock(c, features * 2 ** i,
                                                   spatial_stride=2))
            c = features * 2 ** i
            h, w = -(-h // 2), -(-w // 2)         # 'SAME' stride 2
        self.fc = Dense(h * w * c, 8 * features)
        out = {"TOS_regression": n_sectors,
               "LMA_sector_classification": 2 * n_sectors,
               "LMA_slice_classification": 2}[LMA_task]
        self.head = Dense(8 * features, out)

    def forward(self, disp: torch.Tensor) -> Dict[str, torch.Tensor]:
        """disp (B, 2, H, W, T), or (B, 2, T, H, W) with
        ``time_axis_last=False`` -> the task's output."""
        if self.time_axis_last:
            disp = disp.permute(0, 1, 4, 2, 3)            # (B, 2, T, H, W)
        b, c, t, h, w = disp.shape
        y = disp.transpose(1, 2).reshape(b * t, c, h, w)
        y = y.to(torch.bfloat16).contiguous()
        for blk in self.blocks:
            y = blk(y, t)
        # the mean over time of the (h, w, c)-flattened features (NHWC, as
        # flax flattens them)
        feat = y.permute(0, 2, 3, 1).reshape(b, t, -1).mean(dim=1)
        feat = gelu(self.fc(feat.float()))
        out = self.head(feat)
        if self.task == "TOS_regression":
            return {"TOS": F.softplus(out) + 1.0}
        if self.task == "LMA_sector_classification":
            return {"sector_LMA_labels": out.reshape(b, 2, self.n_sectors)}
        return {"slice_LMA_label": out}
