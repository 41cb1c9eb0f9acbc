"""K2 + K3: one EPDiff Euler step and its VJP, CUDA kernels + plain.

Counterpart of ``cardiax/ops/epdiff_pallas.py:epdiff_step`` (``_fwd_kernel``
forward, ``_bwd_kernel`` backward), unpacked items only:

    (v, m, u) (N, 2, H, W) -> (m - dt * ad*_v m,  b + warp(u, b)),  b = -dt v

with one-sided border differences and the warp clamped to
|b| <= radius - 1. The kernels are in ``cardiax_torch/csrc/epdiff_step.cu``;
``_epdiff_step_plain`` and ``_epdiff_step_bwd_plain`` are the same functions
in plain PyTorch, used for CPU tensors and as the kernels' checks.
``EPDiffStep`` ties them into autograd; it saves (v, m, u) as
``epdiff_pallas._step_fwd`` does.

``launches`` and ``bwd_launches`` count the forward and backward kernel
launches of this process.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from cardiax_torch.kernels.build import (check, check_inputs, load_library,
                                         require_cuda)
from cardiax_torch.ops.warp_kernels import (_mc_warp_plain, clip_masks,
                                            coordinate_vjp)

launches = 0
bwd_launches = 0


def grad_hw(f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central d/dy, d/dx of (..., H, W), one-sided at the borders
    (``cardiax/ops/shooting.py:_grad_hw``)."""
    fy = torch.cat([f[..., 1:2, :] - f[..., 0:1, :],
                    (f[..., 2:, :] - f[..., :-2, :]) * 0.5,
                    f[..., -1:, :] - f[..., -2:-1, :]], dim=-2)
    fx = torch.cat([f[..., :, 1:2] - f[..., :, 0:1],
                    (f[..., :, 2:] - f[..., :, :-2]) * 0.5,
                    f[..., :, -1:] - f[..., :, -2:-1]], dim=-1)
    return fy, fx


def grad_hw_t(g: torch.Tensor, dim: int) -> torch.Tensor:
    """The exact transpose of ``grad_hw``'s stencil along ``dim`` (-2 or
    -1), for sizes >= 4: ``epdiff_pallas.py:_dyT``/``_dxT`` term for term."""
    n = g.shape[dim]
    k = torch.arange(n, device=g.device).view((n, 1) if dim == -2 else (n,))
    up = torch.roll(g, -1, dim)          # g(k + 1)
    dn = torch.roll(g, 1, dim)           # g(k - 1)
    base = 0.5 * (dn - up)
    out = torch.where(k == 0, -g - 0.5 * up, base)
    out = torch.where(k == 1, base + 0.5 * dn, out)
    out = torch.where(k == n - 2, base - 0.5 * up, out)
    return torch.where(k == n - 1, 0.5 * dn + g, out)


def _epdiff_step_plain(v: torch.Tensor, m: torch.Tensor, u: torch.Tensor,
                       dt: float, radius: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel semantics in plain PyTorch, in the kernel's evaluation order."""
    vy, vx = v[:, 0], v[:, 1]
    my, mx = m[:, 0], m[:, 1]
    dvy_dy, dvy_dx = grad_hw(vy)
    dvx_dy, dvx_dx = grad_hw(vx)
    dmy_dy, dmy_dx = grad_hw(my)
    dmx_dy, dmx_dx = grad_hw(mx)
    div = dvy_dy + dvx_dx
    a_y = dvy_dy * my + dvx_dy * mx + dmy_dy * vy + dmy_dx * vx + my * div
    a_x = dvy_dx * my + dvx_dx * mx + dmx_dy * vy + dmx_dx * vx + mx * div
    m_new = torch.stack([my - dt * a_y, mx - dt * a_x], dim=1)
    b = -dt * v
    return m_new, b + _mc_warp_plain(u, b, radius)


def _warp_transpose(b: torch.Tensor, g: torch.Tensor,
                    radius: int) -> torch.Tensor:
    """The adjoint of ``u -> _mc_warp_plain(u, b, radius)`` applied to ``g``
    (N, C, H, W), as the band sweep of ``epdiff_pallas._bwd_kernel``: the
    weighted cotangent of each source pixel moves to its taps by circular
    rolls, and the hat weights are zero for every tap that wraps."""
    _, _, h, w = g.shape
    ii = torch.arange(h, device=g.device, dtype=g.dtype).view(1, h, 1)
    jj = torch.arange(w, device=g.device, dtype=g.dtype).view(1, 1, w)
    r = float(radius - 1)
    cy = (ii + b[:, 0].clamp(-r, r)).clamp(0.0, h - 1.0)
    cx = (jj + b[:, 1].clamp(-r, r)).clamp(0.0, w - 1.0)
    y0, x0 = torch.floor(cy), torch.floor(cx)
    fy, fx = cy - y0, cx - x0
    y1 = torch.clamp(y0 + 1.0, max=h - 1.0)
    x1 = torch.clamp(x0 + 1.0, max=w - 1.0)

    def hat(k, a0, a1, f):
        """warp_pallas.py:_hat: both terms add where a0 == a1."""
        return torch.where(k == a0, 1.0 - f, 0.0) + torch.where(k == a1, f, 0.0)

    wys = [hat(ii + d, y0, y1, fy).unsqueeze(1)
           for d in range(-radius, radius + 1)]
    acc = torch.zeros_like(g)
    for e in range(-radius, radius + 1):
        a_e = g * hat(jj + e, x0, x1, fx).unsqueeze(1)
        b_e = torch.zeros_like(g)
        for d in range(-radius, radius + 1):
            b_e = b_e + torch.roll(wys[d + radius] * a_e, d, -2)
        acc = acc + torch.roll(b_e, e, -1)
    return acc


def _epdiff_step_bwd_plain(v, m, u, gm, gu, dt: float, radius: int):
    """(g_v, g_m, g_u) of one step given the cotangents (gm, gu) of (m', u'):
    the hand-derived adjoint of ``epdiff_pallas._bwd_kernel``, in its order
    (module docstring there, :22-27)."""
    vy, vx = v[:, 0], v[:, 1]
    my, mx = m[:, 0], m[:, 1]
    dvy_dy, dvy_dx = grad_hw(vy)
    dvx_dy, dvx_dx = grad_hw(vx)
    dmy_dy, dmy_dx = grad_hw(my)
    dmx_dy, dmx_dx = grad_hw(mx)
    div = dvy_dy + dvx_dx
    gmy, gmx = gm[:, 0], gm[:, 1]

    # warp adjoint: u' = b + warp(u, b)
    b = -dt * v
    acc_dy, acc_dx = coordinate_vjp(u, b, gu, radius)
    wmy, wmx = clip_masks(b[:, 0], b[:, 1], float(radius - 1))
    g_by = gu[:, 0] + acc_dy * wmy
    g_bx = gu[:, 1] + acc_dx * wmx
    g_u = _warp_transpose(b, gu, radius)

    # ad* adjoint, cotangent a = -dt * gm'
    a_y, a_x = -dt * gmy, -dt * gmx

    def dyt(x):
        return grad_hw_t(x, -2)

    def dxt(x):
        return grad_hw_t(x, -1)

    gv_y = (dyt(2.0 * a_y * my + a_x * mx) + dxt(a_x * my)
            + a_y * dmy_dy + a_x * dmx_dy - dt * g_by)
    gv_x = (dyt(a_y * mx) + dxt(a_y * my + 2.0 * a_x * mx)
            + a_y * dmy_dx + a_x * dmx_dx - dt * g_bx)
    gm_y = (gmy + a_y * (dvy_dy + div) + a_x * dvy_dx
            + dyt(a_y * vy) + dxt(a_y * vx))
    gm_x = (gmx + a_y * dvx_dy + a_x * (dvx_dx + div)
            + dyt(a_x * vy) + dxt(a_x * vx))
    return (torch.stack([gv_y, gv_x], dim=1), torch.stack([gm_y, gm_x], dim=1),
            g_u)


def _epdiff_step_cuda(v, m, u, dt: float, radius: int):
    global launches
    require_cuda("epdiff_step_fwd", v=v, m=m, u=u)
    fn = load_library("epdiff_step").epdiff_step_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n, _, h, w = v.shape
    m_out = torch.empty_like(m)
    u_out = torch.empty_like(u)
    with torch.cuda.device(v.device):
        err = fn(v.data_ptr(), m.data_ptr(), u.data_ptr(), m_out.data_ptr(),
                 u_out.data_ptr(), n, h, w, float(dt), int(radius),
                 torch.cuda.current_stream().cuda_stream)
    check(err, "epdiff_step_fwd")
    launches += 1
    return m_out, u_out


def _epdiff_step_bwd_cuda(v, m, u, gm, gu, dt: float, radius: int):
    global bwd_launches
    require_cuda("epdiff_step_bwd", v=v, m=m, u=u, gm=gm, gu=gu)
    fn = load_library("epdiff_step").epdiff_step_bwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n, _, h, w = v.shape
    g_v, g_m, g_u = (torch.empty_like(v) for _ in range(3))
    with torch.cuda.device(v.device):
        err = fn(v.data_ptr(), m.data_ptr(), u.data_ptr(), gm.data_ptr(),
                 gu.data_ptr(), g_v.data_ptr(), g_m.data_ptr(), g_u.data_ptr(),
                 n, h, w, float(dt), int(radius),
                 torch.cuda.current_stream().cuda_stream)
    check(err, "epdiff_step_bwd")
    bwd_launches += 1
    return g_v, g_m, g_u


def epdiff_step_bwd(v, m, u, gm, gu, dt: float, radius: int):
    """(g_v, g_m, g_u) of one step from the cotangents (gm, gu) of its
    outputs. A CUDA tensor goes through kernel K3 (or raises), a CPU tensor
    through ``_epdiff_step_bwd_plain``. The transposed border stencil is
    exact only for H, W >= 4, so smaller planes are refused."""
    if min(v.shape[-2:]) < 4:
        raise ValueError("epdiff_step_bwd: needs H, W >= 4 (the transposed "
                         "one-sided stencil), got "
                         f"{tuple(v.shape[-2:])}")
    check_inputs("epdiff_step_bwd", v=v, m=m, u=u, gm=gm, gu=gu)
    if v.device.type == "cpu":
        return _epdiff_step_bwd_plain(v, m, u, gm, gu, dt, radius)
    return _epdiff_step_bwd_cuda(v, m, u, gm, gu, dt, radius)


class EPDiffStep(torch.autograd.Function):
    """K2 forward, K3 backward; a cotangent that arrives as None (m' of the
    last step) is zeros."""

    @staticmethod
    def forward(ctx, v, m, u, dt: float, radius: int):
        ctx.dt, ctx.radius = dt, radius
        ctx.save_for_backward(v, m, u)
        if v.device.type == "cpu":
            return _epdiff_step_plain(v, m, u, dt, radius)
        return _epdiff_step_cuda(v, m, u, dt, radius)

    @staticmethod
    def backward(ctx, gm, gu):
        v, m, u = ctx.saved_tensors
        gm = torch.zeros_like(m) if gm is None else gm.contiguous()
        gu = torch.zeros_like(u) if gu is None else gu.contiguous()
        g_v, g_m, g_u = epdiff_step_bwd(v, m, u, gm, gu, ctx.dt, ctx.radius)
        return g_v, g_m, g_u, None, None


def epdiff_step(v: torch.Tensor, m: torch.Tensor, u: torch.Tensor,
                dt: float, radius: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(v, m, u) (N, 2, H, W) -> (m', u') of one Euler step, differentiable.

    A CUDA tensor goes through the kernels (or raises); a CPU tensor through
    the plain versions. Inputs must be contiguous float32."""
    if v.dim() != 4 or v.shape[1] != 2 or m.shape != v.shape \
            or u.shape != v.shape:
        raise ValueError(f"epdiff_step_fwd: v {tuple(v.shape)}, m "
                         f"{tuple(m.shape)}, u {tuple(u.shape)} must all be "
                         f"(N, 2, H, W)")
    if min(v.shape[-2:]) < 2 or radius < 1:
        raise ValueError("epdiff_step_fwd: needs H, W >= 2 and radius >= 1")
    check_inputs("epdiff_step_fwd", v=v, m=m, u=u)
    return EPDiffStep.apply(v, m, u, dt, radius)
