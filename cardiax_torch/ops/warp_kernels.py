"""K1 + K4: the multi-channel clamped bilinear warp, CUDA kernels + plain.

Counterpart of ``cardiax/ops/warp_pallas.py:bilinear_warp_banded_multi``
(``_mc_tap_kernel`` forward, ``_mc_disp_bwd_kernel`` backward). Every channel
of a field is warped by one shared displacement, clamped to +-(radius - 1)
px, with the sample coordinate clipped to the frame. The kernels are in
``cardiax_torch/csrc/mc_warp.cu``; ``_mc_warp_plain`` and
``_mc_warp_disp_bwd_plain`` are the same functions in plain PyTorch, used for
CPU tensors and as the kernels' checks.

``MCWarp`` ties them into autograd. Its backward returns d/d disp only: the
field must be data (``img_const=True``, as the final image warp of the joint
network). A field that needs its own gradient needs the fused backward
(``_mc_fused_bwd_kernel``, ROADMAP B5), which is not ported.

``launches`` and ``bwd_launches`` count the forward and backward kernel
launches of this process.
"""

from __future__ import annotations

import ctypes

import torch

from cardiax_torch.kernels.build import (check, check_inputs, load_library,
                                         require_cuda)
from cardiax_torch.ops.warp import gather_taps, sample_coords

launches = 0
bwd_launches = 0


def _mc_warp_plain(field: torch.Tensor, disp: torch.Tensor,
                   radius: int) -> torch.Tensor:
    """field (N, C, H, W), disp (N, 2, H, W) -> (N, C, H, W); kernel
    semantics, clamp included, in the kernel's tap order."""
    taps, fy, fx = sample_coords(disp[:, 0], disp[:, 1], float(radius - 1))
    v00, v01, v10, v11 = gather_taps(field, taps)
    fy, fx = fy.unsqueeze(1), fx.unsqueeze(1)
    wy0, wx0 = 1.0 - fy, 1.0 - fx
    return wx0 * (wy0 * v00 + fy * v10) + fx * (wy0 * v01 + fy * v11)


def clip_masks(dy: torch.Tensor, dx: torch.Tensor, r: float):
    """(my, mx) on (N, H, W): 1 where neither the clamp at +-r nor the frame
    clip bites, tested on the unclamped displacement
    (``warp_pallas.py:_window_coords``)."""
    _, h, w = dy.shape
    ii = torch.arange(h, device=dy.device, dtype=dy.dtype).view(1, h, 1)
    jj = torch.arange(w, device=dy.device, dtype=dy.dtype).view(1, 1, w)
    my = (dy.abs() <= r) & (ii + dy >= 0.0) & (ii + dy <= h - 1.0)
    mx = (dx.abs() <= r) & (jj + dx >= 0.0) & (jj + dx <= w - 1.0)
    return my.to(dy.dtype), mx.to(dx.dtype)


def coordinate_vjp(field: torch.Tensor, disp: torch.Tensor,
                   g: torch.Tensor, radius: int):
    """The channel-summed cotangent of the sample coordinate (dy, dx) of
    the clamped warp, before the clip masks: each (N, H, W). Summed as the
    band sweep does, column x0 over channels, then column x1."""
    taps, fy, fx = sample_coords(disp[:, 0], disp[:, 1], float(radius - 1))
    v00, v01, v10, v11 = gather_taps(field, taps)
    sx = (taps[1] != taps[0]).view_as(fy).to(fy.dtype)   # 0 where x1 == x0
    wy0, wx0 = 1.0 - fy, 1.0 - fx
    acc_dy = torch.zeros_like(fy)
    acc_dx = torch.zeros_like(fy)
    for w_col, s_col, top, bot in ((wx0, -sx, v00, v10), (fx, sx, v01, v11)):
        for c in range(field.shape[1]):
            gc = g[:, c]
            acc_dy = acc_dy + (w_col * gc) * (bot[:, c] - top[:, c])
            acc_dx = acc_dx + (s_col * gc) * (wy0 * top[:, c] + fy * bot[:, c])
    return acc_dy, acc_dx


def _mc_warp_disp_bwd_plain(field: torch.Tensor, disp: torch.Tensor,
                            g: torch.Tensor, radius: int) -> torch.Tensor:
    """d/d disp (N, 2, H, W) of ``sum(g * _mc_warp_plain(field, disp))``,
    the kernel's explicit adjoint."""
    acc_dy, acc_dx = coordinate_vjp(field, disp, g, radius)
    my, mx = clip_masks(disp[:, 0], disp[:, 1], float(radius - 1))
    return torch.stack([acc_dy * my, acc_dx * mx], dim=1)


def _mc_warp_cuda(field: torch.Tensor, disp: torch.Tensor,
                  radius: int) -> torch.Tensor:
    global launches
    require_cuda("mc_warp_fwd", field=field, disp=disp)
    fn = load_library("mc_warp").mc_warp_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n, c, h, w = field.shape
    out = torch.empty_like(field)
    with torch.cuda.device(field.device):
        err = fn(field.data_ptr(), disp.data_ptr(), out.data_ptr(), n, c, h, w,
                 int(radius), torch.cuda.current_stream().cuda_stream)
    check(err, "mc_warp_fwd")
    launches += 1
    return out


def _mc_warp_disp_bwd_cuda(field: torch.Tensor, disp: torch.Tensor,
                           g: torch.Tensor, radius: int) -> torch.Tensor:
    global bwd_launches
    require_cuda("mc_warp_disp_bwd", field=field, disp=disp, g=g)
    fn = load_library("mc_warp").mc_warp_disp_bwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n, c, h, w = field.shape
    gdisp = torch.empty_like(disp)
    with torch.cuda.device(field.device):
        err = fn(field.data_ptr(), disp.data_ptr(), g.data_ptr(),
                 gdisp.data_ptr(), n, c, h, w, int(radius),
                 torch.cuda.current_stream().cuda_stream)
    check(err, "mc_warp_disp_bwd")
    bwd_launches += 1
    return gdisp


def mc_warp_disp_bwd(field: torch.Tensor, disp: torch.Tensor,
                     g: torch.Tensor, radius: int) -> torch.Tensor:
    """d/d disp (N, 2, H, W) of the warp, given its output's cotangent ``g``
    (N, C, H, W). A CUDA tensor goes through kernel K4 (or raises), a CPU
    tensor through ``_mc_warp_disp_bwd_plain``."""
    if g.shape != field.shape:
        raise ValueError(f"mc_warp_disp_bwd: g {tuple(g.shape)} must match "
                         f"field {tuple(field.shape)}")
    check_inputs("mc_warp_disp_bwd", field=field, disp=disp, g=g)
    if field.device.type == "cpu":
        return _mc_warp_disp_bwd_plain(field, disp, g, radius)
    return _mc_warp_disp_bwd_cuda(field, disp, g, radius)


class MCWarp(torch.autograd.Function):
    """K1 forward, K4 backward (d/d disp only; the field is data)."""

    @staticmethod
    def forward(ctx, field, disp, radius: int):
        ctx.radius = radius
        ctx.save_for_backward(field, disp)
        if field.device.type == "cpu":
            return _mc_warp_plain(field, disp, radius)
        return _mc_warp_cuda(field, disp, radius)

    @staticmethod
    def backward(ctx, g):
        field, disp = ctx.saved_tensors
        gdisp = None
        if ctx.needs_input_grad[1]:
            gdisp = mc_warp_disp_bwd(field, disp, g.contiguous(), ctx.radius)
        return None, gdisp, None


def bilinear_warp_banded_multi(field: torch.Tensor, disp: torch.Tensor,
                               radius: int = 8,
                               img_const: bool = False) -> torch.Tensor:
    """Warp every channel of ``field`` (..., C, H, W) by ONE displacement
    ``disp`` (..., 2, H, W), clamped to +-(radius - 1) px.

    A CUDA tensor goes through the kernels (or raises); a CPU tensor through
    the plain versions. Inputs must be contiguous float32. Gradients flow to
    ``disp``; ``img_const=True`` declares that the field needs none. A field
    that requires grad without it raises: its backward (ROADMAP B5) is not
    ported."""
    h, w = field.shape[-2:]
    c = field.shape[-3]
    if disp.shape[-3:] != (2, h, w) or disp.shape[:-3] != field.shape[:-3]:
        raise ValueError(f"mc_warp_fwd: field {tuple(field.shape)} and disp "
                         f"{tuple(disp.shape)} do not match")
    if radius < 1:
        raise ValueError(f"mc_warp_fwd: radius must be >= 1, got {radius}")
    check_inputs("mc_warp_fwd", field=field, disp=disp)
    if field.requires_grad and not img_const and torch.is_grad_enabled():
        raise NotImplementedError(
            "bilinear_warp_banded_multi: d/d field (the fused backward "
            "_mc_fused_bwd_kernel, ROADMAP B5) is not ported; pass "
            "img_const=True when the field is data")
    out = MCWarp.apply(field.reshape(-1, c, h, w), disp.reshape(-1, 2, h, w),
                       radius)
    return out.reshape(field.shape)
