"""K1: the multi-channel clamped bilinear warp (forward), CUDA kernel + plain.

Counterpart of ``cardiax/ops/warp_pallas.py:bilinear_warp_banded_multi``
(forward of ``_mc_tap_kernel``). Every channel of a field is warped by one
shared displacement, clamped to +-(radius - 1) px, with the sample
coordinate clipped to the frame. The kernel is
``cardiax_torch/csrc/mc_warp.cu``; ``_mc_warp_plain`` is the same function
in plain PyTorch, used for CPU tensors and as the kernel's check.

``launches`` counts the kernel launches of this process.
"""

from __future__ import annotations

import ctypes

import torch

from cardiax_torch.kernels.build import (check, check_inputs, load_library,
                                         require_cuda)
from cardiax_torch.ops.warp import gather_taps, sample_coords

launches = 0


def _mc_warp_plain(field: torch.Tensor, disp: torch.Tensor,
                   radius: int) -> torch.Tensor:
    """field (N, C, H, W), disp (N, 2, H, W) -> (N, C, H, W); kernel
    semantics, clamp included, in the kernel's tap order."""
    taps, fy, fx = sample_coords(disp[:, 0], disp[:, 1], float(radius - 1))
    v00, v01, v10, v11 = gather_taps(field, taps)
    fy, fx = fy.unsqueeze(1), fx.unsqueeze(1)
    wy0, wx0 = 1.0 - fy, 1.0 - fx
    return wx0 * (wy0 * v00 + fy * v10) + fx * (wy0 * v01 + fy * v11)


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


def bilinear_warp_banded_multi(field: torch.Tensor, disp: torch.Tensor,
                               radius: int = 8) -> torch.Tensor:
    """Warp every channel of ``field`` (..., C, H, W) by ONE displacement
    ``disp`` (..., 2, H, W), clamped to +-(radius - 1) px.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor through
    ``_mc_warp_plain``. Inputs must be contiguous float32; forward only, so
    inputs that require grad are refused while grad mode is on."""
    h, w = field.shape[-2:]
    c = field.shape[-3]
    if disp.shape[-3:] != (2, h, w) or disp.shape[:-3] != field.shape[:-3]:
        raise ValueError(f"mc_warp_fwd: field {tuple(field.shape)} and disp "
                         f"{tuple(disp.shape)} do not match")
    if radius < 1:
        raise ValueError(f"mc_warp_fwd: radius must be >= 1, got {radius}")
    check_inputs("mc_warp_fwd", field=field, disp=disp)
    f = field.reshape(-1, c, h, w)
    d = disp.reshape(-1, 2, h, w)
    if field.device.type == "cpu":
        out = _mc_warp_plain(f, d, radius)
    else:
        out = _mc_warp_cuda(f, d, radius)
    return out.reshape(field.shape)
