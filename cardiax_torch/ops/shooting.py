"""Geodesic shooting: EPDiff integration of an initial momentum field.

Counterpart of ``cardiax/ops/shooting.py`` (``ad_star``,
``expmap_shooting``, ``expmap_svf``, ``deform_image``; ``_grad_hw`` is
``epdiff_kernels.grad_hw``, which the kernel's plain version shares). Given
m0 (B, 2, H, W):

    v_t = K m_t,  d m_t / dt = -ad*_{v_t} m_t,
    phi^{-1}_{t+dt}(x) = phi^{-1}_t(x - dt v_t(x)),

integrated with ``n_steps`` Euler steps. Each step's pointwise core
(derivatives, ad*, the clamped semi-Lagrangian warp of u) is one launch of
kernel K2 (``epdiff_kernels.epdiff_step``) at band radius
min(2, warp_radius), its backward one launch of K3; the solve v = K m stays
a float32 DFT matmul (rfft2 above 128 px a side). ``warp_radius=None``
takes the exact composite path (``ad_star`` and the unclamped gather warp).
The final image warp ``deform_image`` is kernel K1; its backward is K4 when
the image is data, else K5 (``warp_kernels``).

``_FUSED_SOLVE = True`` (off by default, under JAX's name and as JAX's
test/probe hook) folds the solve into the step: every step, step 0
included, is one launch of K6 (``epdiff_kernels.epdiff_step_solve``) and
its backward one of K7, on integration grids with both sides at most
``_MM_MAX_SIDE`` (128); larger grids keep the separate solve. JAX caps the
lane-packed plane instead (``epdiff_pallas.pack_plan``), so a 128^2 grid
packs to 256x128 there and takes the separate solve; the port does not
pack, and both forms compute the same operator, so here 128^2 items take
the fused solve. ``remat=True`` recomputes each step in the backward
(``torch.utils.checkpoint``), which changes no value.

There is no ``scan_plan`` or ``warp_plan`` here. The TPU chooses its
lowering by VMEM size: the fused step only where a plane fits one block,
else the composite scan of per-op kernels; full-frame, multi-channel or
row-tiled warp kernels by frame size and channel count. On Hopper nothing
of that binds: K2/K3 integrate every grid, and K1, K4 and K5 warp every
frame and channel count, so the port has one path for each. (The fused
step equals the composite one: ``tests/test_torch_warp_grad.py``.)
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from cardiax_torch.ops.epdiff_kernels import (epdiff_step, epdiff_step_solve,
                                              grad_hw)
from cardiax_torch.ops.fluid_metric import _MM_MAX_SIDE, sharp, spectral_resize
from cardiax_torch.ops.warp import bilinear_warp, warp_vector_field
from cardiax_torch.ops.warp_kernels import bilinear_warp_banded_multi

# True runs each Euler step through the fused-solve kernels (module
# docstring); None/False keeps the separate solve. Read at every call.
_FUSED_SOLVE: Optional[bool] = None


def ad_star(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Coadjoint action ad*_v m = (Dv)^T m + (Dm) v + m div(v);
    v, m (B, 2, H, W) with channel 0 = y, 1 = x."""
    vy, vx = v[:, 0], v[:, 1]
    my, mx = m[:, 0], m[:, 1]
    dvy_dy, dvy_dx = grad_hw(vy)
    dvx_dy, dvx_dx = grad_hw(vx)
    dmy_dy, dmy_dx = grad_hw(my)
    dmx_dy, dmx_dx = grad_hw(mx)
    div_v = dvy_dy + dvx_dx
    out_y = (dvy_dy * my + dvx_dy * mx) + (dmy_dy * vy + dmy_dx * vx) \
        + my * div_v
    out_x = (dvy_dx * my + dvx_dx * mx) + (dmx_dy * vy + dmx_dx * vx) \
        + mx * div_v
    return torch.stack([out_y, out_x], dim=1)


def expmap_shooting(m0: torch.Tensor, alpha: float = 2.0, gamma: float = 1.0,
                    power: int = 2, n_steps: int = 5,
                    warp_radius: Optional[int] = 8,
                    shoot_downsample: int = 1,
                    remat: bool = False,
                    return_low: bool = False):
    """EPDiff shooting. Returns (u_inv, v0), or (u_inv, v0, u_low_px) with
    ``return_low=True``:

      u_inv (B, 2, H, W): displacement of the inverse map,
                          deformed_source(x) = src(x + u_inv(x));
      v0    (B, 2, H, W): initial velocity K m0;
      u_low_px: the same displacement in full-pixel units on the
                integration grid (H/ds, W/ds), or None at full resolution.

    ``shoot_downsample=ds`` integrates on the (H/ds, W/ds) grid with
    alpha/ds^2 and resamples the displacement back spectrally (the metric
    kills the frequencies the small grid cannot hold). ``remat=True``
    recomputes each Euler step in the backward instead of keeping its
    activations; as in JAX it does not reach a downsampled integration.
    """
    h_full, w_full = m0.shape[-2:]
    if shoot_downsample > 1 and (h_full % shoot_downsample
                                 or w_full % shoot_downsample
                                 or min(h_full, w_full) < 4 * shoot_downsample):
        shoot_downsample = 1   # tiny/odd grids: integrate at full resolution
    if shoot_downsample > 1:
        ds = int(shoot_downsample)
        v0 = sharp(m0, alpha, gamma, power)
        m_low = spectral_resize(m0, (h_full // ds, w_full // ds)) / ds
        u_low, _ = expmap_shooting(
            m_low, alpha=alpha / (ds * ds), gamma=gamma, power=power,
            n_steps=n_steps, warp_radius=warp_radius, shoot_downsample=1)
        u_inv = spectral_resize(u_low, (h_full, w_full)) * ds
        if return_low:
            return u_inv, v0, u_low * ds
        return u_inv, v0

    dt = 1.0 / n_steps
    v0 = sharp(m0, alpha, gamma, power)
    m, u_inv = m0, torch.zeros_like(m0)
    if warp_radius is not None and _FUSED_SOLVE \
            and max(h_full, w_full) <= _MM_MAX_SIDE:
        radius = min(2, warp_radius)

        def step_solve(m, u_inv):
            return epdiff_step_solve(m, u_inv, dt, radius, alpha, gamma,
                                     power)

        step = _remat(step_solve) if remat else step_solve
        for _ in range(n_steps):
            m, u_inv = step(m, u_inv)
    else:
        if warp_radius is None:
            def step(v, m, u_inv):
                back = -dt * v
                return (m - dt * ad_star(v, m),
                        back + warp_vector_field(u_inv, back))
        else:
            radius = min(2, warp_radius)

            def step(v, m, u_inv):
                return epdiff_step(v, m, u_inv, dt, radius)
        if remat:
            step = _remat(step)
        for t in range(n_steps):
            v = v0 if t == 0 else sharp(m, alpha, gamma, power)
            m, u_inv = step(v, m, u_inv)
    if return_low:
        return u_inv, v0, None   # integration ran at full resolution
    return u_inv, v0


def _remat(step):
    """``step`` recomputed in the backward instead of saving its
    activations (JAX's ``jax.checkpoint``)."""
    return lambda *args: checkpoint(step, *args, use_reentrant=False)


def expmap_svf(v: torch.Tensor, n_squarings: int = 4,
               warp_radius: Optional[int] = 8) -> torch.Tensor:
    """Stationary-velocity scaling and squaring: the displacement u of
    exp(v), exp(v)(x) = x + u(x). v (B, 2, H, W).

    u <- v / 2^n, then n times u <- u(x) + u(x + u(x)): each squaring warps
    u by itself (kernel K1, clamped at warp_radius - 1 px; backward K5, both
    inputs). ``warp_radius=None`` takes the unclamped gather. JAX
    checkpoints each squaring, which changes no value; here autograd keeps
    the n intermediate fields."""
    u = (v / (2.0 ** n_squarings)).contiguous()
    for _ in range(n_squarings):
        if warp_radius is None:
            u = u + warp_vector_field(u, u)
        else:
            u = u + bilinear_warp_banded_multi(u, u, radius=warp_radius)
    return u


def deform_image(img: torch.Tensor, u_inv: torch.Tensor,
                 warp_radius: Optional[int] = 12,
                 img_const: bool = False) -> torch.Tensor:
    """deformed(x) = img(x + u_inv(x)); img (B, C, H, W), u_inv (B, 2, H, W).

    ``warp_radius`` bounds the final deformation: displacements clamp at
    radius - 1 px (kernel K1 forward; backward K5, or K4 with
    ``img_const``). ``None`` takes the exact unclamped gather.
    ``img_const=True`` declares that no gradient w.r.t. ``img`` is needed
    (warping source data)."""
    if warp_radius is not None:
        return bilinear_warp_banded_multi(img, u_inv, radius=warp_radius,
                                          img_const=img_const)
    if img_const:
        img = img.detach()
    return torch.stack([bilinear_warp(img[:, i], u_inv)
                        for i in range(img.shape[1])], dim=1)
