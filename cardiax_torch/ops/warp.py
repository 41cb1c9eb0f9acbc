"""Exact bilinear gather warp.

Counterpart of ``cardiax/ops/warp.py`` (``bilinear_warp``,
``warp_vector_field``, ``compose_displacements``): samples ``img`` at
``x + disp(x)`` with the sample coordinate clipped to the frame and no clamp
on the displacement. The clamped warp of the kernels lives in
``warp_kernels``; both share the coordinate and tap helpers below.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def sample_coords(dy: torch.Tensor, dx: torch.Tensor,
                  clamp: Optional[float] = None):
    """Bilinear pieces of the coordinate (i + dy, j + dx) on (N, H, W) planes.

    The displacement is clamped to +-``clamp`` when given, the coordinate is
    clipped to [0, H-1] x [0, W-1], and the far tap is min(near + 1, H - 1)
    (``cardiax/ops/warp_pallas.py:_window_coords``). Returns flat tap indices
    (i00, i01, i10, i11) of shape (N, H*W) and the fractions (fy, fx)."""
    n, h, w = dy.shape
    ii = torch.arange(h, device=dy.device, dtype=dy.dtype).view(1, h, 1)
    jj = torch.arange(w, device=dy.device, dtype=dy.dtype).view(1, 1, w)
    if clamp is not None:
        dy = dy.clamp(-clamp, clamp)
        dx = dx.clamp(-clamp, clamp)
    cy = (ii + dy).clamp(0.0, h - 1.0)
    cx = (jj + dx).clamp(0.0, w - 1.0)
    y0 = torch.floor(cy)
    x0 = torch.floor(cx)
    fy = cy - y0
    fx = cx - x0
    y0i = y0.long()
    x0i = x0.long()
    y1i = (y0i + 1).clamp(max=h - 1)
    x1i = (x0i + 1).clamp(max=w - 1)
    taps = tuple((yi * w + xi).reshape(n, h * w)
                 for yi, xi in ((y0i, x0i), (y0i, x1i), (y1i, x0i), (y1i, x1i)))
    return taps, fy, fx


def gather_taps(img: torch.Tensor, taps) -> Tuple[torch.Tensor, ...]:
    """img (N, C, H, W); flat tap indices (N, H*W) -> four (N, C, H, W)."""
    n, c, h, w = img.shape
    flat = img.reshape(n, c, h * w)
    return tuple(torch.gather(flat, 2, t.unsqueeze(1).expand(n, c, h * w))
                 .reshape(n, c, h, w) for t in taps)


def bilinear_warp(img: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """img (..., H, W), disp (..., 2, H, W) [dy, dx] in pixels -> img sampled
    at identity + disp."""
    h, w = img.shape[-2:]
    img_flat = img.reshape(-1, 1, h, w)
    disp_flat = disp.reshape(-1, 2, h, w)
    if disp_flat.shape[0] != img_flat.shape[0]:
        raise ValueError(f"batch mismatch: img {tuple(img.shape)} vs disp "
                         f"{tuple(disp.shape)}")
    taps, wy, wx = sample_coords(disp_flat[:, 0], disp_flat[:, 1])
    v00, v01, v10, v11 = gather_taps(img_flat, taps)
    wy, wx = wy.unsqueeze(1), wx.unsqueeze(1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return (top * (1 - wy) + bot * wy).reshape(img.shape)


def warp_vector_field(field: torch.Tensor, disp: torch.Tensor,
                      warp_fn: Optional[Callable] = None) -> torch.Tensor:
    """Warp each channel of a (..., C, H, W) field by one (..., 2, H, W)
    displacement."""
    wf = warp_fn or bilinear_warp
    return torch.stack([wf(field[..., i, :, :], disp)
                        for i in range(field.shape[-3])], dim=-3)


def compose_displacements(u_outer: torch.Tensor, u_inner: torch.Tensor,
                          warp_fn: Optional[Callable] = None) -> torch.Tensor:
    """Displacement of the composition (id + u_outer) o (id + u_inner):
    u(x) = u_inner(x) + u_outer(x + u_inner(x)). ``warp_fn(img, disp)`` warps
    one channel (default the exact gather; ``warp_kernels.
    bilinear_warp_banded`` for the clamped kernels)."""
    return u_inner + warp_vector_field(u_outer, u_inner, warp_fn)
