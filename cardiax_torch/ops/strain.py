"""Displacement -> 126-sector circumferential strain, assembled on the device.

Counterpart of ``cardiax/ops/strain.py``: from Lagrangian displacement
fields and the frame-0 myocardium mask, the Green-Lagrange circumferential
strain E_cc per angular sector. Every function takes a batch of any leading
shape (JAX's take one item and ``vmap`` it); the per-sector reduction is one
(S, H*W) x (H*W, T) product per item (``torch.matmul``), not a scatter, and
the geometry (centroid, sector ids, tangent directions) is computed from the
inputs on their device.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from cardiax_torch.ops.epdiff_kernels import grad_hw


def _grid(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, 1) row and (1, W) column coordinates, f32, on the mask's device."""
    h, w = mask.shape[-2:]
    yy = torch.arange(h, dtype=torch.float32, device=mask.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=mask.device)[None, :]
    return yy, xx


def mask_centroid(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centroid (cy, cx) of (..., H, W) masks (safe for empty masks)."""
    yy, xx = _grid(mask)
    total = mask.sum((-2, -1)).clamp_min(1e-6)
    return ((yy * mask).sum((-2, -1)) / total,
            (xx * mask).sum((-2, -1)) / total)


def _angles(mask: torch.Tensor) -> torch.Tensor:
    """(..., H, W) angle of each pixel about the mask's centroid, (-pi, pi]."""
    yy, xx = _grid(mask)
    cy, cx = mask_centroid(mask)
    return torch.atan2(yy - cy[..., None, None], xx - cx[..., None, None])


def _sector_matrix(mask: torch.Tensor, theta: torch.Tensor,
                   n_sectors: int) -> torch.Tensor:
    sec = torch.floor((theta + math.pi) / (2 * math.pi) * n_sectors)
    sec = sec.clamp(0, n_sectors - 1).to(torch.int64).flatten(-2)
    ids = torch.arange(n_sectors, device=mask.device)[:, None]
    onehot = (ids == sec[..., None, :]).to(torch.float32)
    return onehot * mask.flatten(-2)[..., None, :]


def sector_matrix(mask: torch.Tensor, n_sectors: int = 126) -> torch.Tensor:
    """(..., S, H*W) assignment pixel -> angular sector, masked by the
    myocardium. Sector 0 starts at angle -pi."""
    return _sector_matrix(mask, _angles(mask), n_sectors)


def circumferential_strain(disp: torch.Tensor, mask: torch.Tensor,
                           n_sectors: int = 126) -> torch.Tensor:
    """Sector-wise Green-Lagrange circumferential strain.

    disp (..., 2, T, H, W): Lagrangian displacement [dy, dx] of the
    material points of frame 0 at each frame t; mask (..., H, W): the
    frame-0 myocardium mask; returns (..., S, T)."""
    theta = _angles(mask)
    # the circumferential unit vector e_c = (-sin, cos) in (y, x)
    ey, ex = torch.cos(theta)[..., None, :, :], -torch.sin(theta)[..., None, :, :]
    duy_dy, duy_dx = grad_hw(disp[..., 0, :, :, :])        # (..., T, H, W)
    dux_dy, dux_dx = grad_hw(disp[..., 1, :, :, :])
    # E = 0.5 (Du + Du^T + Du^T Du), projected: E_cc = e^T E e
    e_yy = duy_dy + 0.5 * (duy_dy ** 2 + dux_dy ** 2)
    e_xx = dux_dx + 0.5 * (duy_dx ** 2 + dux_dx ** 2)
    e_yx = 0.5 * (duy_dx + dux_dy + duy_dy * duy_dx + dux_dy * dux_dx)
    ecc = e_yy * ey ** 2 + 2.0 * e_yx * ey * ex + e_xx * ex ** 2

    sec_mat = _sector_matrix(mask, theta, n_sectors)           # (..., S, HW)
    counts = sec_mat.sum(-1, keepdim=True).clamp_min(1e-6)
    vals = ecc.flatten(-2).transpose(-1, -2)                    # (..., HW, T)
    return torch.matmul(sec_mat, vals) / counts


def strain_matrix_from_displacements(disp: torch.Tensor, mask0: torch.Tensor,
                                     n_sectors: int = 126) -> torch.Tensor:
    """disp (B, 2, T, H, W), mask0 (B, H, W) -> (B, S, T)."""
    return circumferential_strain(disp, mask0, n_sectors)
