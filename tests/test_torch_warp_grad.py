"""The warp's full gradient in the port against the JAX package, on the CPU.

K5 (``cardiax_torch/csrc/mc_warp.cu``) computes the warp's backward with
respect to the warped field, and K4's displacement backward with it. Its
plain version ``_mc_warp_fused_bwd_plain`` is held here against every Pallas
kernel that computes that function, each in interpret mode at its own
layout: the multi-channel fused backward (B5), the single-channel full-frame
kernels (B6 in all three modes, B7, B8) and the row-tiled ones (B9, B10).
Then the ops built on it (``bilinear_warp_banded``, ``expmap_svf``,
``compose_displacements``, ``deform_image``) against their JAX counterparts,
and the fused EPDiff step (K2/K3) against the port's own composite step.

Inputs are made with numpy from a seed; displacements reach 15 px so that
the clamp at radius - 1 and the frame clip both bite. Tolerances: 1e-5 for
values (one op, as ``tests/test_ops.py``), 1e-4 for gradients (its gradient
tolerance).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

import cardiax.ops.shooting as jax_shooting
import cardiax.ops.warp_pallas as wp
from cardiax.ops import warp as jwarp
from cardiax_torch.ops import epdiff_kernels as tek
from cardiax_torch.ops import shooting as tshooting
from cardiax_torch.ops import warp as twarp
from cardiax_torch.ops import warp_kernels as twk
from torch_budget import time_limit  # noqa: F401


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _field(rng, shape, sigma, scale):
    """A smooth field normalised to a max |value| of ``scale``."""
    f = ndimage.gaussian_filter(rng.normal(size=shape), sigma)
    return (f / np.abs(f).max() * scale).astype(np.float32)


def _bites(disp, radius):
    """Assert that the clamp at radius - 1 and the frame clip both bite."""
    r = radius - 1
    assert (np.abs(disp) > r).mean() > 0.01
    h = disp.shape[-2]
    cy = np.arange(h)[:, None] + np.clip(disp[..., 0, :, :], -r, r)
    assert ((cy < 0) | (cy > h - 1)).any()


def _close(out, ref, tol):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    np.testing.assert_allclose(out, np.asarray(ref), atol=tol, rtol=tol)


# --------------------------------------------------------------------------- #
# B5: the multi-channel fused backward                                         #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("channels,radius", [(1, 2), (2, 2), (1, 12)])
def test_fused_bwd_plain_matches_pallas_vjp(channels, radius):
    rng = np.random.default_rng(50 + channels + radius)
    field = _field(rng, (2, channels, 32, 32), 2.0, 4.0)
    disp = _field(rng, (2, 2, 32, 32), 3.0, 15.0)
    g = rng.normal(size=field.shape).astype(np.float32)
    _bites(disp, radius)
    _, vjp = jax.vjp(lambda f, d: wp._banded_warp_mc(f, d, radius, True, False),
                     jnp.asarray(field), jnp.asarray(disp))
    g_field, g_disp = vjp(jnp.asarray(g))
    out_f, out_d = twk._mc_warp_fused_bwd_plain(_t(field), _t(disp), _t(g),
                                                radius)
    _close(out_f, g_field, 1e-4)
    _close(out_d, g_disp, 1e-4)


@pytest.mark.parametrize("channels", [1, 3])
def test_fused_bwd_plain_is_the_autograd_of_the_plain_forward(channels):
    """The adjoint against autograd of the forward's gather, and MCWarp's
    backward (both outputs, or d/d field alone) against the plain version."""
    rng = np.random.default_rng(60 + channels)
    field, disp = (_t(_field(rng, (2, c, 24, 20), 2.0, s))
                   for c, s in ((channels, 4.0), (2, 15.0)))
    g = _t(rng.normal(size=field.shape).astype(np.float32))
    leaves = [x.clone().requires_grad_() for x in (field, disp)]
    refs = torch.autograd.grad((twk._mc_warp_plain(*leaves, 12) * g).sum(),
                               leaves)
    outs = twk._mc_warp_fused_bwd_plain(field, disp, g, 12)
    for out, ref in zip(outs, refs):
        err = (out - ref).abs().max() / ref.abs().max()
        assert err < 1e-5, err
    leaves = [x.clone().requires_grad_() for x in (field, disp)]
    warped = twk.bilinear_warp_banded_multi(*leaves, radius=12)
    got = torch.autograd.grad((warped * g).sum(), leaves)
    for out, ref in zip(got, outs):
        assert torch.equal(out, ref)
    f = field.clone().requires_grad_()
    got_f, = torch.autograd.grad(
        (twk.bilinear_warp_banded_multi(f, disp, radius=12) * g).sum(), f)
    assert torch.equal(got_f, outs[0])
    gf, gd = twk.mc_warp_fused_bwd(field, disp, g, 12, with_disp=False)
    assert gd is None and torch.equal(gf, outs[0])


# --------------------------------------------------------------------------- #
# B6, B7, B8: the single-channel full-frame kernels                            #
# --------------------------------------------------------------------------- #

def _single(seed, shape=(3, 32, 24), disp_shape=(3, 2, 32, 24), amp=6.0):
    rng = np.random.default_rng(seed)
    img = _field(rng, shape, 2.0, 3.0)
    disp = _field(rng, disp_shape, 3.0, amp)
    g = rng.normal(size=shape).astype(np.float32)
    return img, disp, g


def _single_vs_jax(img, disp, g, radius):
    _bites(disp, radius)
    out_j, vjp = jax.vjp(
        lambda i, d: wp.bilinear_warp_banded(i, d, radius=radius,
                                             interpret=True),
        jnp.asarray(img), jnp.asarray(disp))
    gi_j, gd_j = vjp(jnp.asarray(g))
    i_t, d_t = _t(img).requires_grad_(), _t(disp).requires_grad_()
    out_t = twk.bilinear_warp_banded(i_t, d_t, radius=radius)
    gi_t, gd_t = torch.autograd.grad((out_t * _t(g)).sum(), (i_t, d_t))
    _close(out_t, out_j, 1e-5)
    _close(gi_t, gi_j, 1e-4)
    _close(gd_t, gd_j, 1e-4)


@pytest.mark.parametrize("broadcast", [False, True])
def test_single_channel_matches_fused_full_frame_kernels(broadcast):
    """B6 ('value') forward and B8 (all three gradients in one sweep); with
    ``broadcast`` one displacement serves three images."""
    assert wp._unroll_plan(32, 24, 4, n_lists=2)[0]      # B8 engages
    disp_shape = (2, 32, 24) if broadcast else (3, 2, 32, 24)
    _single_vs_jax(*_single(70 + broadcast, disp_shape=disp_shape), radius=4)


def test_single_channel_matches_three_kernel_backward(monkeypatch):
    """B6 in its 'ddy' and 'ddx' modes plus B7 (d/d img): the backward that
    the TPU takes where the fused one does not fit."""
    unroll_plan = wp._unroll_plan
    monkeypatch.setattr(
        wp, "_unroll_plan", lambda h, w, r, n_lists=1: (False, False)
        if n_lists == 2 else unroll_plan(h, w, r, n_lists))
    _single_vs_jax(*_single(72), radius=4)


# --------------------------------------------------------------------------- #
# B9, B10: the row-tiled kernels of large frames                               #
# --------------------------------------------------------------------------- #

def test_single_channel_matches_tiled_kernels(monkeypatch):
    """B9 (value, ddy, ddx) and B10 (d/d img) with 16-row tiles on a 48x64
    frame, as ``tests/test_ops.py::TestTiledBandedWarp``; the top and bottom
    rows are pushed out of the frame so that the first and last blocks'
    windows clamp."""
    monkeypatch.setattr(wp, "_MAX_VMEM_PIXELS", 1024)
    monkeypatch.setattr(wp, "_MAX_FULL_WARP_PIXELS", 1024)
    monkeypatch.setattr(wp, "_TILE_ROWS", 16)
    img, disp, g = _single(74, shape=(2, 48, 64), disp_shape=(2, 2, 48, 64),
                           amp=8.0)
    assert wp._tile_plan(48, 64, 4) == 16 and 48 * 64 > 1024
    disp[:, 0, :8] = -9.5
    disp[:, 0, -8:] = 6.9
    _single_vs_jax(img, disp, g, radius=4)


# --------------------------------------------------------------------------- #
# The ops: expmap_svf, compose_displacements, deform_image                     #
# --------------------------------------------------------------------------- #

@pytest.fixture
def jax_banded(monkeypatch):
    """JAX's shooting warps through the multi-channel Pallas kernels in
    interpret mode (its CPU default is the unclamped gather)."""
    monkeypatch.setattr(jax_shooting, "bilinear_warp_banded_multi",
                        functools.partial(wp.bilinear_warp_banded_multi,
                                          interpret=True))


def test_expmap_svf_matches_jax(jax_banded):
    rng = np.random.default_rng(80)
    v = _field(rng, (2, 2, 32, 32), 4.0, 40.0)      # |v / 16| up to 2.5 px
    g = rng.normal(size=v.shape).astype(np.float32)
    u_j, vjp = jax.vjp(lambda x: jax_shooting.expmap_svf(
        x, n_squarings=4, warp_radius=3), jnp.asarray(v))
    gv_j, = vjp(jnp.asarray(g))
    v_t = _t(v).requires_grad_()
    u_t = tshooting.expmap_svf(v_t, n_squarings=4, warp_radius=3)
    gv_t, = torch.autograd.grad((u_t * _t(g)).sum(), v_t)
    assert np.abs(np.asarray(u_j)).max() > 2.0        # the clamp at 2 px bites
    _close(u_t, u_j, 1e-5 * max(1.0, np.abs(np.asarray(u_j)).max()))
    _close(gv_t, gv_j, 1e-4)
    # without a radius both take the unclamped gather
    u_j = jax_shooting.expmap_svf(jnp.asarray(v), 3, warp_radius=None)
    _close(tshooting.expmap_svf(_t(v), 3, warp_radius=None), u_j, 1e-5)


def test_compose_displacements_matches_jax():
    rng = np.random.default_rng(81)
    outer, inner = (_field(rng, (2, 2, 32, 24), 3.0, 6.0) for _ in range(2))
    g = rng.normal(size=outer.shape).astype(np.float32)
    _bites(inner, 3)
    wf_j = functools.partial(wp.bilinear_warp_banded, radius=3, interpret=True)
    out_j, vjp = jax.vjp(lambda a, b: jwarp.compose_displacements(a, b, wf_j),
                         jnp.asarray(outer), jnp.asarray(inner))
    refs = vjp(jnp.asarray(g))
    leaves = [_t(x).requires_grad_() for x in (outer, inner)]
    wf_t = functools.partial(twk.bilinear_warp_banded, radius=3)
    out_t = twarp.compose_displacements(*leaves, warp_fn=wf_t)
    grads = torch.autograd.grad((out_t * _t(g)).sum(), leaves)
    _close(out_t, out_j, 1e-5)
    for got, ref in zip(grads, refs):
        _close(got, ref, 1e-4)
    # the default warp_fn is the exact gather on both sides
    _close(twarp.compose_displacements(_t(outer), _t(inner)),
           jwarp.compose_displacements(jnp.asarray(outer),
                                       jnp.asarray(inner)), 1e-5)


def test_deform_image_gradient_of_the_image_matches_jax(jax_banded):
    rng = np.random.default_rng(82)
    img = _field(rng, (2, 1, 32, 32), 2.0, 1.0)
    u = _field(rng, (2, 2, 32, 32), 3.0, 8.0)
    g = rng.normal(size=img.shape).astype(np.float32)
    _bites(u, 4)
    _, vjp = jax.vjp(lambda i, d: jax_shooting.deform_image(
        i, d, warp_radius=4, img_const=False), jnp.asarray(img), jnp.asarray(u))
    refs = vjp(jnp.asarray(g))
    leaves = [_t(x).requires_grad_() for x in (img, u)]
    out = tshooting.deform_image(*leaves, warp_radius=4, img_const=False)
    grads = torch.autograd.grad((out * _t(g)).sum(), leaves)
    for got, ref in zip(grads, refs):
        _close(got, ref, 1e-4)
    # img_const: no gradient reaches the image
    i_c = _t(img).requires_grad_()
    out = tshooting.deform_image(i_c, _t(u), warp_radius=4, img_const=True)
    assert not out.requires_grad


# --------------------------------------------------------------------------- #
# The fused EPDiff step equals the composite step                              #
# --------------------------------------------------------------------------- #

def test_fused_step_equals_composite_step():
    """One K2/K3 step (plain versions) against ``ad_star`` plus the
    multi-channel warp whose field gradient is ``_mc_warp_fused_bwd_plain``:
    values and all three gradients. It pins the choice of K2/K3 at every
    grid size, where the TPU runs the composite scan above 256^2."""
    rng = np.random.default_rng(90)
    shape = (2, 2, 24, 20)
    v, m, u = (_field(rng, shape, 2.5, s) for s in (9.0, 3.0, 2.0))
    gm, gu = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    _bites(-0.2 * v, 2)
    dt, radius = 0.2, 2

    def run(step):
        leaves = [_t(x).requires_grad_() for x in (v, m, u)]
        m1, u1 = step(*leaves)
        grads = torch.autograd.grad((m1 * _t(gm)).sum() + (u1 * _t(gu)).sum(),
                                    leaves)
        return (m1, u1) + grads

    def composite(vv, mm, uu):
        back = -dt * vv
        return (mm - dt * tshooting.ad_star(vv, mm),
                back + twk.bilinear_warp_banded_multi(uu, back, radius))

    fused = run(lambda vv, mm, uu: tek.epdiff_step(vv, mm, uu, dt, radius))
    for out, ref in zip(fused, run(composite)):
        ref = ref.detach()
        err = (out.detach() - ref).abs().max() / ref.abs().max()
        assert err < 1e-5, err
