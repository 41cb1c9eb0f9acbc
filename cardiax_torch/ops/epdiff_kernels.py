"""K2: one forward EPDiff Euler step, CUDA kernel + plain.

Counterpart of ``cardiax/ops/epdiff_pallas.py:epdiff_step`` (forward of
``_fwd_kernel``), unpacked items only:

    (v, m, u) (N, 2, H, W) -> (m - dt * ad*_v m,  b + warp(u, b)),  b = -dt v

with one-sided border differences and the warp clamped to
|b| <= radius - 1. The kernel is ``cardiax_torch/csrc/epdiff_step.cu``;
``_epdiff_step_plain`` is the same function in plain PyTorch, used for CPU
tensors and as the kernel's check.

``launches`` counts the kernel launches of this process.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from cardiax_torch.kernels.build import (check, check_inputs, load_library,
                                         require_cuda)
from cardiax_torch.ops.warp_kernels import _mc_warp_plain

launches = 0


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


def epdiff_step(v: torch.Tensor, m: torch.Tensor, u: torch.Tensor,
                dt: float, radius: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(v, m, u) (N, 2, H, W) -> (m', u') of one Euler step.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor through
    ``_epdiff_step_plain``. Inputs must be contiguous float32; forward only,
    so inputs that require grad are refused while grad mode is on."""
    if v.dim() != 4 or v.shape[1] != 2 or m.shape != v.shape \
            or u.shape != v.shape:
        raise ValueError(f"epdiff_step_fwd: v {tuple(v.shape)}, m "
                         f"{tuple(m.shape)}, u {tuple(u.shape)} must all be "
                         f"(N, 2, H, W)")
    if min(v.shape[-2:]) < 2 or radius < 1:
        raise ValueError("epdiff_step_fwd: needs H, W >= 2 and radius >= 1")
    check_inputs("epdiff_step_fwd", v=v, m=m, u=u)
    if v.device.type == "cpu":
        return _epdiff_step_plain(v, m, u, dt, radius)
    return _epdiff_step_cuda(v, m, u, dt, radius)
