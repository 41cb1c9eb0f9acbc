"""K2/K3 and K6/K7: one EPDiff Euler step and its VJP, CUDA kernels + plain.

Counterpart of ``cardiax/ops/epdiff_pallas.py:epdiff_step`` (``_fwd_kernel``
forward, ``_bwd_kernel`` backward) and ``epdiff_step_solve``
(``_fwd_solve_kernel``, ``_bwd_solve_kernel``), unpacked items only:

    (v, m, u) (N, 2, H, W) -> (m - dt * ad*_v m,  b + warp(u, b)),  b = -dt v

with one-sided border differences and the warp clamped to
|b| <= radius - 1; the fused-solve step computes v = K m itself, as the
four products of ``epdiff_pallas._solve_mm`` on the operands of
``fluid_metric.solve_mm_operands``, and its VJP adds K g_v to g_m. The
kernels are in ``cardiax_torch/csrc/epdiff_step.cu``; the ``_plain``
functions here are the same functions in plain PyTorch, used for CPU
tensors and as the kernels' checks.

Each kernel is a ``torch.library`` custom op (``cardiax_torch::
epdiff_step_fwd``, ``epdiff_step_bwd``, ``epdiff_step_solve_fwd``,
``epdiff_step_solve_bwd``): the CUDA implementation launches the kernel,
the CPU one is the plain version, the fake one gives ``torch.export`` the
output shapes, so an exported program holds the kernels. ``dt`` and
``radius`` are Python scalars in the schema. The forward ops carry their
backward (``register_autograd``): K2's is K3, saving (v, m, u) as
``epdiff_pallas._step_fwd`` does; K6's is K7, saving only (m, u), as
``_step_solve_fwd`` does.

Each wrapper counts its kernel's launches in ``ops.counters`` (K2
``epdiff_step_fwd``, K3 ``epdiff_step_bwd``, K6 ``epdiff_step_solve_fwd``,
K7 ``epdiff_step_solve_bwd``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from cardiax_torch.kernels.build import (check, check_inputs, load_library,
                                         require_cpu_or_cuda, require_cuda)
from cardiax_torch.ops import counters
from cardiax_torch.ops.fluid_metric import solve_mm_operands
from cardiax_torch.ops.warp_kernels import (_mc_warp_plain, _warp_transpose,
                                            clip_masks, coordinate_vjp)


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
    counters.count("epdiff_step_fwd")
    return m_out, u_out


def _epdiff_step_bwd_cuda(v, m, u, gm, gu, dt: float, radius: int):
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
    counters.count("epdiff_step_bwd")
    return g_v, g_m, g_u


@torch.library.custom_op("cardiax_torch::epdiff_step_fwd", mutates_args=(),
                         device_types="cuda")
def epdiff_step_fwd_op(v: torch.Tensor, m: torch.Tensor, u: torch.Tensor,
                       dt: float, radius: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    return _epdiff_step_cuda(v, m, u, dt, radius)


epdiff_step_fwd_op.register_kernel("cpu")(_epdiff_step_plain)


@epdiff_step_fwd_op.register_fake
def _(v, m, u, dt, radius):
    return torch.empty_like(m), torch.empty_like(u)


@torch.library.custom_op("cardiax_torch::epdiff_step_bwd", mutates_args=(),
                         device_types="cuda")
def epdiff_step_bwd_op(v: torch.Tensor, m: torch.Tensor, u: torch.Tensor,
                       gm: torch.Tensor, gu: torch.Tensor, dt: float,
                       radius: int
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _epdiff_step_bwd_cuda(v, m, u, gm, gu, dt, radius)


epdiff_step_bwd_op.register_kernel("cpu")(_epdiff_step_bwd_plain)


@epdiff_step_bwd_op.register_fake
def _(v, m, u, gm, gu, dt, radius):
    return torch.empty_like(v), torch.empty_like(m), torch.empty_like(u)


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
    require_cpu_or_cuda("epdiff_step_bwd", v=v, m=m, u=u, gm=gm, gu=gu)
    return epdiff_step_bwd_op(v, m, u, gm, gu, float(dt), int(radius))


def _epdiff_step_setup(ctx, inputs, output):
    v, m, u, dt, radius = inputs
    ctx.dt, ctx.radius = dt, radius
    ctx.save_for_backward(v, m, u)


def _epdiff_step_backward(ctx, gm, gu):
    """K3; a cotangent that arrives as None (m' of the last step) is
    zeros."""
    v, m, u = ctx.saved_tensors
    gm = torch.zeros_like(m) if gm is None else gm.contiguous()
    gu = torch.zeros_like(u) if gu is None else gu.contiguous()
    g_v, g_m, g_u = epdiff_step_bwd(v, m, u, gm, gu, ctx.dt, ctx.radius)
    return g_v, g_m, g_u, None, None


epdiff_step_fwd_op.register_autograd(_epdiff_step_backward,
                                     setup_context=_epdiff_step_setup)


def _check_step_inputs(what: str, radius: int, **planes) -> None:
    """The checks of ``epdiff_step``/``epdiff_step_solve``: every input
    (N, 2, H, W) of one shape, H, W >= 2, radius >= 1, contiguous f32."""
    first = next(iter(planes.values()))
    if first.dim() != 4 or first.shape[1] != 2 \
            or any(t.shape != first.shape for t in planes.values()):
        shapes = ", ".join(f"{k} {tuple(t.shape)}" for k, t in planes.items())
        raise ValueError(f"{what}: {shapes} must all be (N, 2, H, W)")
    if min(first.shape[-2:]) < 2 or radius < 1:
        raise ValueError(f"{what}: needs H, W >= 2 and radius >= 1")
    check_inputs(what, **planes)
    require_cpu_or_cuda(what, **planes)


def epdiff_step(v: torch.Tensor, m: torch.Tensor, u: torch.Tensor,
                dt: float, radius: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(v, m, u) (N, 2, H, W) -> (m', u') of one Euler step, differentiable.

    A CUDA tensor goes through the kernels (or raises); a CPU tensor through
    the plain versions. Inputs must be contiguous float32."""
    _check_step_inputs("epdiff_step_fwd", radius, v=v, m=m, u=u)
    return epdiff_step_fwd_op(v, m, u, float(dt), int(radius))


# --------------------------------------------------------------------------- #
# K6 + K7: the step with the solve v = K m inside the kernel                   #
# --------------------------------------------------------------------------- #

def _solve_operands(h: int, w: int, alpha: float, gamma: float, power: int,
                    device):
    """(ty, tx, wgt): the three of ``solve_mm_operands``' five that K6/K7
    take (they read Ty^T and Tx^T as index swaps)."""
    ty, _, _, tx, wgt = solve_mm_operands(h, w, 1, 1, alpha, gamma, power,
                                          device=device)
    return ty, tx, wgt


def _solve_plain(x: torch.Tensor, ty: torch.Tensor, tx: torch.Tensor,
                 wgt: torch.Tensor) -> torch.Tensor:
    """Ty^T [ (Ty x Tx^T) * W ] Tx on each (H, W) plane of x: the four
    products of ``epdiff_pallas._solve_mm``, in its order."""
    a = ty @ x
    a = (a @ tx.T) * wgt
    a = ty.T @ a
    return a @ tx


def _epdiff_step_solve_plain(m, u, ty, tx, wgt, dt: float, radius: int):
    """K6 in plain PyTorch: v = K m, then ``_epdiff_step_plain``
    (``epdiff_pallas._fwd_solve_kernel`` term for term)."""
    return _epdiff_step_plain(_solve_plain(m, ty, tx, wgt), m, u, dt, radius)


def _epdiff_step_solve_bwd_plain(m, u, ty, tx, wgt, gm, gu, dt: float,
                                 radius: int):
    """(g_m, g_u) of the fused-solve step (K7 in plain PyTorch): v
    recomputed, K3's adjoint, then g_m += K g_v (K is self-adjoint;
    ``epdiff_pallas._bwd_solve_kernel``)."""
    v = _solve_plain(m, ty, tx, wgt)
    g_v, g_m, g_u = _epdiff_step_bwd_plain(v, m, u, gm, gu, dt, radius)
    return g_m + _solve_plain(g_v, ty, tx, wgt), g_u


# K6/K7 keep an item's rows in the shared memory of a cluster of at most 8
# blocks of 16 rows: ``epdiff_pallas._MAX_SOLVE_SIDE``, the largest plane
# ``expmap_shooting`` gives the fused solve (``fluid_metric._MM_MAX_SIDE``)
MAX_SOLVE_SIDE = 128


def _check_solve_side(what: str, m: torch.Tensor) -> None:
    if max(m.shape[-2:]) > MAX_SOLVE_SIDE:
        raise ValueError(f"{what}: the kernel takes planes of at most "
                         f"{MAX_SOLVE_SIDE} px a side, got "
                         f"{tuple(m.shape[-2:])}")


def _solve_fn(name: str, n_ptrs: int):
    fn = getattr(load_library("epdiff_step"), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _epdiff_step_solve_cuda(m, u, ty, tx, wgt, dt: float, radius: int):
    require_cuda("epdiff_step_solve_fwd", m=m, u=u, ty=ty, tx=tx, wgt=wgt)
    _check_solve_side("epdiff_step_solve_fwd", m)
    fn = _solve_fn("epdiff_step_solve_fwd", 8)
    n, _, h, w = m.shape
    m_out = torch.empty_like(m)
    u_out = torch.empty_like(u)
    with torch.cuda.device(m.device):      # no scratch: v stays on chip
        err = fn(m.data_ptr(), u.data_ptr(), ty.data_ptr(), tx.data_ptr(),
                 wgt.data_ptr(), m_out.data_ptr(), u_out.data_ptr(), None,
                 n, h, w, float(dt), int(radius),
                 torch.cuda.current_stream().cuda_stream)
    check(err, "epdiff_step_solve_fwd")
    counters.count("epdiff_step_solve_fwd")
    return m_out, u_out


def _epdiff_step_solve_bwd_cuda(m, u, ty, tx, wgt, gm, gu, dt: float,
                                radius: int):
    require_cuda("epdiff_step_solve_bwd", m=m, u=u, ty=ty, tx=tx, wgt=wgt,
                 gm=gm, gu=gu)
    _check_solve_side("epdiff_step_solve_bwd", m)
    fn = _solve_fn("epdiff_step_solve_bwd", 10)
    n, _, h, w = m.shape
    g_m = torch.empty_like(m)
    g_u = torch.empty_like(u)
    with torch.cuda.device(m.device):      # no scratch: v, g_v stay on chip
        err = fn(m.data_ptr(), u.data_ptr(), ty.data_ptr(), tx.data_ptr(),
                 wgt.data_ptr(), gm.data_ptr(), gu.data_ptr(),
                 g_m.data_ptr(), g_u.data_ptr(), None, n, h, w, float(dt),
                 int(radius), torch.cuda.current_stream().cuda_stream)
    check(err, "epdiff_step_solve_bwd")
    counters.count("epdiff_step_solve_bwd")
    return g_m, g_u


@torch.library.custom_op("cardiax_torch::epdiff_step_solve_fwd",
                         mutates_args=(), device_types="cuda")
def epdiff_step_solve_fwd_op(m: torch.Tensor, u: torch.Tensor,
                             ty: torch.Tensor, tx: torch.Tensor,
                             wgt: torch.Tensor, dt: float, radius: int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    return _epdiff_step_solve_cuda(m, u, ty, tx, wgt, dt, radius)


epdiff_step_solve_fwd_op.register_kernel("cpu")(_epdiff_step_solve_plain)


@epdiff_step_solve_fwd_op.register_fake
def _(m, u, ty, tx, wgt, dt, radius):
    return torch.empty_like(m), torch.empty_like(u)


@torch.library.custom_op("cardiax_torch::epdiff_step_solve_bwd",
                         mutates_args=(), device_types="cuda")
def epdiff_step_solve_bwd_op(m: torch.Tensor, u: torch.Tensor,
                             ty: torch.Tensor, tx: torch.Tensor,
                             wgt: torch.Tensor, gm: torch.Tensor,
                             gu: torch.Tensor, dt: float, radius: int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    return _epdiff_step_solve_bwd_cuda(m, u, ty, tx, wgt, gm, gu, dt, radius)


epdiff_step_solve_bwd_op.register_kernel("cpu")(_epdiff_step_solve_bwd_plain)


@epdiff_step_solve_bwd_op.register_fake
def _(m, u, ty, tx, wgt, gm, gu, dt, radius):
    return torch.empty_like(m), torch.empty_like(u)


def epdiff_step_solve_bwd(m, u, ty, tx, wgt, gm, gu, dt: float, radius: int):
    """(g_m, g_u) of one fused-solve step from the cotangents (gm, gu) of
    its outputs. A CUDA tensor goes through kernel K7 (or raises), a CPU
    tensor through ``_epdiff_step_solve_bwd_plain``. Planes under 4 px are
    refused, as by ``epdiff_step_bwd``."""
    if min(m.shape[-2:]) < 4:
        raise ValueError("epdiff_step_solve_bwd: needs H, W >= 4 (the "
                         "transposed one-sided stencil), got "
                         f"{tuple(m.shape[-2:])}")
    check_inputs("epdiff_step_solve_bwd", m=m, u=u, gm=gm, gu=gu)
    require_cpu_or_cuda("epdiff_step_solve_bwd", m=m, u=u, gm=gm, gu=gu)
    return epdiff_step_solve_bwd_op(m, u, ty, tx, wgt, gm, gu, float(dt),
                                    int(radius))


def _epdiff_step_solve_setup(ctx, inputs, output):
    """Saves only (m, u): the backward recomputes v. The solve's operands
    are constants without gradients, kept on the context."""
    m, u, ty, tx, wgt, dt, radius = inputs
    ctx.dt, ctx.radius = dt, radius
    ctx.operands = (ty, tx, wgt)
    ctx.save_for_backward(m, u)


def _epdiff_step_solve_backward(ctx, gm, gu):
    """K7; a cotangent that arrives as None is zeros."""
    m, u = ctx.saved_tensors
    gm = torch.zeros_like(m) if gm is None else gm.contiguous()
    gu = torch.zeros_like(u) if gu is None else gu.contiguous()
    g_m, g_u = epdiff_step_solve_bwd(m, u, *ctx.operands, gm, gu, ctx.dt,
                                     ctx.radius)
    return g_m, g_u, None, None, None, None, None


epdiff_step_solve_fwd_op.register_autograd(
    _epdiff_step_solve_backward, setup_context=_epdiff_step_solve_setup)


def epdiff_step_solve(m: torch.Tensor, u: torch.Tensor, dt: float,
                      radius: int, alpha: float = 2.0, gamma: float = 1.0,
                      power: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m, u) (N, 2, H, W) -> (m', u') of one Euler step with v = K m
    computed inside the step (K the fluid metric of (alpha, gamma, power)),
    differentiable in m and u.

    A CUDA tensor goes through kernels K6/K7 (or raises); a CPU tensor
    through the plain versions. Inputs must be contiguous float32."""
    _check_step_inputs("epdiff_step_solve_fwd", radius, m=m, u=u)
    h, w = m.shape[-2:]
    ty, tx, wgt = _solve_operands(h, w, alpha, gamma, power, m.device)
    return epdiff_step_solve_fwd_op(m, u, ty, tx, wgt, float(dt), int(radius))
