"""Momentum UNet: (src, tar) image pair -> initial momentum field m0.

Counterpart of ``cardiax/models/unet.py:MomentumUNet`` with
``channel_pack`` off. Public layout as in JAX: input NHWC (B, H, W, 2),
output momentum NHWC (B, H, W, 2); NCHW inside. The trunk runs in bfloat16
(cast at the input, as ``unet.py:190``); the momentum head is a float32 conv
(``unet.py:232``), which JAX zero-initialises. With ``half_res`` and a frame
of at least 4 * 2^levels per side, the network runs at H/2 x W/2 behind a
stride-2 stem and the momentum is spectrally upsampled back.
"""

from __future__ import annotations

import torch
from torch import nn

from cardiax_torch.models.layers import Conv, ConvBlock
from cardiax_torch.ops.fluid_metric import spectral_resize


def _repeat2(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x.repeat_interleave(2, dim)`` as a broadcast view, equal in value
    and gradient: the repeat count never becomes a device tensor whose
    output size is read back to the host (capture-safe on the card)."""
    shape = list(x.shape)
    shape.insert(dim + 1, 2)
    return x.unsqueeze(dim + 1).expand(shape).flatten(dim, dim + 1)


class MomentumUNet(nn.Module):
    def __init__(self, features: int = 16, n_levels: int = 3,
                 half_res: bool = False):
        super().__init__()
        f, lv = features, n_levels
        self.n_levels = lv
        self.half_res = half_res
        widths = [f * 2 ** i for i in range(lv)]
        self.stem = ConvBlock(2, f, stride=2) if half_res else None
        c = f if half_res else 2                 # input channels: src, tar
        self.enc = nn.ModuleList()
        self.down = nn.ModuleList()
        for fl in widths:
            self.enc.append(ConvBlock(c, fl))
            self.down.append(ConvBlock(fl, fl, stride=2))
            c = fl
        fb = f * 2 ** lv
        self.mid = nn.ModuleList([ConvBlock(c, fb), ConvBlock(fb, fb)])
        self.up_conv = nn.ModuleList()
        self.dec = nn.ModuleList()
        c = fb
        for fl in reversed(widths):
            self.up_conv.append(Conv(c, fl))
            self.dec.append(ConvBlock(2 * fl, fl))
            c = fl
        self.head = Conv(f, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 2) -> momentum (B, H, W, 2) float32."""
        h_full, w_full = x.shape[1], x.shape[2]
        half = self.half_res and h_full % 2 == 0 and w_full % 2 == 0 \
            and min(h_full, w_full) >= 4 * 2 ** self.n_levels
        if self.half_res and not half:
            # JAX builds this model without the stem at such frames; the
            # port fixes the layer list at construction
            raise ValueError(
                f"half_res MomentumUNet needs even frames of at least "
                f"{4 * 2 ** self.n_levels} px, got {h_full}x{w_full}")
        x = x.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous()
        if half:
            x = self.stem(x)
        skips = []
        for enc, down in zip(self.enc, self.down):
            x = enc(x)
            skips.append(x)
            x = down(x)
        for blk in self.mid:
            x = blk(x)
        for up_conv, dec, skip in zip(self.up_conv, self.dec, reversed(skips)):
            x = _repeat2(_repeat2(x, 2), 3)
            x = up_conv(x)[:, :, :skip.shape[2], :skip.shape[3]]
            x = dec(torch.cat([x, skip], dim=1))
        m = self.head(x.float())
        if half:
            m = spectral_resize(m, (h_full, w_full))
        return m.permute(0, 2, 3, 1)
