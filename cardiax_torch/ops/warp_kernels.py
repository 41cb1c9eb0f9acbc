"""K1, K4 + K5: the clamped bilinear warp and its two backwards, CUDA + plain.

Counterpart of ``cardiax/ops/warp_pallas.py``: ``bilinear_warp_banded_multi``
(``_mc_tap_kernel`` forward, ``_mc_disp_bwd_kernel`` and
``_mc_fused_bwd_kernel`` backward) and the single-channel
``bilinear_warp_banded`` (``_tap_kernel``, ``_transpose_kernel``,
``_fused_bwd_kernel`` and their row-tiled twins for large frames). Every
channel of a field is warped by one shared displacement, clamped to
+-(radius - 1) px, with the sample coordinate clipped to the frame. The
kernels are in ``cardiax_torch/csrc/mc_warp.cu``; ``_mc_warp_plain``,
``_mc_warp_disp_bwd_plain`` and ``_mc_warp_fused_bwd_plain`` are the same
functions in plain PyTorch, used for CPU tensors and as the kernels' checks.

``MCWarp`` ties them into autograd: K1 forward; backward K4 (d/d disp only)
when the field is data (``img_const=True``, as the final image warp of the
joint network), else K5 (d/d field, and d/d disp when it is wanted). The
TPU picks among its full-frame, multi-channel and row-tiled kernels by VMEM
size; here the same three kernels serve every frame size and channel count.

``launches``, ``bwd_launches`` and ``fused_bwd_launches`` count the K1, K4
and K5 launches of this process.
"""

from __future__ import annotations

import ctypes

import torch

from cardiax_torch.kernels.build import (check, check_inputs, load_library,
                                         require_cuda)
from cardiax_torch.ops.warp import gather_taps, sample_coords

launches = 0
bwd_launches = 0
fused_bwd_launches = 0


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


def _warp_transpose(b: torch.Tensor, g: torch.Tensor,
                    radius: int) -> torch.Tensor:
    """The adjoint of ``u -> _mc_warp_plain(u, b, radius)`` applied to ``g``
    (N, C, H, W), as the band sweep of ``warp_pallas._mc_fused_bwd_kernel``:
    the weighted cotangent of each source pixel moves to its taps by
    circular rolls, and the hat weights are zero for every tap that wraps."""
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


def _mc_warp_fused_bwd_plain(field: torch.Tensor, disp: torch.Tensor,
                             g: torch.Tensor, radius: int,
                             with_disp: bool = True):
    """(d/d field (N, C, H, W), d/d disp (N, 2, H, W) or None) of
    ``sum(g * _mc_warp_plain(field, disp))``: the warp's adjoint and K4's
    explicit displacement adjoint."""
    gdisp = _mc_warp_disp_bwd_plain(field, disp, g, radius) \
        if with_disp else None
    return _warp_transpose(disp, g, radius), gdisp


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


def _mc_warp_fused_bwd_cuda(field: torch.Tensor, disp: torch.Tensor,
                            g: torch.Tensor, radius: int,
                            with_disp: bool = True):
    global fused_bwd_launches
    require_cuda("mc_warp_fused_bwd", field=field, disp=disp, g=g)
    fn = load_library("mc_warp").mc_warp_fused_bwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n, c, h, w = field.shape
    gfield = torch.empty_like(field)
    gdisp = torch.empty_like(disp) if with_disp else None
    band = torch.empty((n, 2), dtype=torch.int32, device=field.device)
    with torch.cuda.device(field.device):
        err = fn(field.data_ptr(), disp.data_ptr(), g.data_ptr(),
                 gfield.data_ptr(), gdisp.data_ptr() if with_disp else None,
                 band.data_ptr(), n, c, h, w, int(radius),
                 torch.cuda.current_stream().cuda_stream)
    check(err, "mc_warp_fused_bwd")
    fused_bwd_launches += 1
    return gfield, gdisp


def mc_warp_fused_bwd(field: torch.Tensor, disp: torch.Tensor,
                      g: torch.Tensor, radius: int, with_disp: bool = True):
    """(d/d field, d/d disp or None) of the warp, given its output's
    cotangent ``g`` (N, C, H, W); ``with_disp=False`` skips d/d disp. A CUDA
    tensor goes through kernel K5 (or raises), a CPU tensor through
    ``_mc_warp_fused_bwd_plain``."""
    if g.shape != field.shape:
        raise ValueError(f"mc_warp_fused_bwd: g {tuple(g.shape)} must match "
                         f"field {tuple(field.shape)}")
    check_inputs("mc_warp_fused_bwd", field=field, disp=disp, g=g)
    if field.device.type == "cpu":
        return _mc_warp_fused_bwd_plain(field, disp, g, radius, with_disp)
    return _mc_warp_fused_bwd_cuda(field, disp, g, radius, with_disp)


class MCWarp(torch.autograd.Function):
    """K1 forward; K5 backward where the field needs its gradient, else K4
    (d/d disp only)."""

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
        want_field, want_disp = ctx.needs_input_grad[:2]
        g = g.contiguous()
        gfield = gdisp = None
        if want_field:
            gfield, gdisp = mc_warp_fused_bwd(field, disp, g, ctx.radius,
                                              with_disp=want_disp)
        elif want_disp:
            gdisp = mc_warp_disp_bwd(field, disp, g, ctx.radius)
        return gfield, gdisp, None


def bilinear_warp_banded_multi(field: torch.Tensor, disp: torch.Tensor,
                               radius: int = 8,
                               img_const: bool = False) -> torch.Tensor:
    """Warp every channel of ``field`` (..., C, H, W) by ONE displacement
    ``disp`` (..., 2, H, W), clamped to +-(radius - 1) px.

    A CUDA tensor goes through the kernels (or raises); a CPU tensor through
    the plain versions. Inputs must be contiguous float32. Gradients flow to
    both inputs; ``img_const=True`` declares that the field needs none, so
    the backward is K4 alone."""
    h, w = field.shape[-2:]
    c = field.shape[-3]
    if disp.shape[-3:] != (2, h, w) or disp.shape[:-3] != field.shape[:-3]:
        raise ValueError(f"mc_warp_fwd: field {tuple(field.shape)} and disp "
                         f"{tuple(disp.shape)} do not match")
    if radius < 1:
        raise ValueError(f"mc_warp_fwd: radius must be >= 1, got {radius}")
    check_inputs("mc_warp_fwd", field=field, disp=disp)
    if img_const:
        field = field.detach()
    out = MCWarp.apply(field.reshape(-1, c, h, w), disp.reshape(-1, 2, h, w),
                       radius)
    return out.reshape(field.shape)


def bilinear_warp_banded(img: torch.Tensor, disp: torch.Tensor,
                         radius: int = 8) -> torch.Tensor:
    """img (..., H, W) sampled at identity + disp (..., 2, H, W), the
    displacement clamped to +-(radius - 1) px; one displacement may serve
    every image (disp with one item). Differentiable in both inputs.

    The single-channel warp of ``warp_pallas.bilinear_warp_banded``: kernels
    K1, K4 and K5 at C = 1 on the card, at every frame size (the TPU's
    full-frame and row-tiled kernels are one kernel each here)."""
    h, w = img.shape[-2:]
    img_flat = img.reshape(-1, 1, h, w)
    disp_flat = disp.reshape(-1, 2, h, w)
    if disp_flat.shape[0] == 1 and img_flat.shape[0] != 1:
        disp_flat = disp_flat.expand(img_flat.shape[0], 2, h, w)
    out = bilinear_warp_banded_multi(img_flat.contiguous(),
                                     disp_flat.contiguous(), radius)
    return out.reshape(img.shape)
