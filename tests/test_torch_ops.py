"""Parity of the port's ops (cardiax_torch.ops) with the JAX package, on CPU.

The same numpy inputs go through the JAX function and its port. The port
runs with device="cpu", so its kernel wrappers take their plain PyTorch
versions; those carry the kernels' exact semantics (clamp included) and are
held here against the Pallas kernels in interpret mode. Tolerances are f32:
1e-5 for one op (as tests/test_ops.py), 1e-4 for five chained Euler steps;
the backward kernels' plain versions are held against ``jax.vjp`` of the
Pallas kernels at the gradient tolerances of tests/test_ops.py (2e-4 for the
EPDiff step, 1e-4 for the warp) and against ``torch.autograd`` of the plain
forwards at 1e-5 of the gradient's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

import cardiax.ops.shooting as jax_shooting
from cardiax.ops import fluid_metric as jfm
from cardiax.ops import svd_smooth as jsvd
from cardiax.ops import warp as jwarp
from cardiax.ops.epdiff_pallas import epdiff_step as jax_epdiff_step
from cardiax.ops.warp_pallas import _banded_warp_mc
from cardiax.ops.warp_pallas import \
    bilinear_warp_banded_multi as jax_warp_multi
from cardiax_torch.ops import fluid_metric as tfm
from cardiax_torch.ops import shooting as tshooting
from cardiax_torch.ops import svd_smooth as tsvd
from cardiax_torch.ops import warp as twarp
from cardiax_torch.ops import epdiff_kernels as tek
from cardiax_torch.ops import warp_kernels as twk
from cardiax_torch.ops.epdiff_kernels import epdiff_step
from cardiax_torch.ops.warp_kernels import bilinear_warp_banded_multi


def _smooth(rng, shape, sigma, scale):
    return (ndimage.gaussian_filter(rng.normal(size=shape), sigma)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _fields(rng, shape, sigma, scale):
    """A smooth field normalised to a max |value| of ``scale``."""
    f = ndimage.gaussian_filter(rng.normal(size=shape), sigma)
    return (f / np.abs(f).max() * scale).astype(np.float32)


# --------------------------------------------------------------------------- #
# K2: the EPDiff step's plain version vs the Pallas kernel (interpret mode)    #
# --------------------------------------------------------------------------- #

def test_epdiff_step_plain_matches_pallas_kernel():
    rng = np.random.default_rng(0)
    shape = (2, 2, 24, 24)
    v = _fields(rng, shape, 2.5, 9.0)       # |dt v| up to 1.8 px
    m = _fields(rng, shape, 2.5, 3.0)
    u = _fields(rng, shape, 2.5, 2.0)
    dt, radius = 0.2, 2
    # the clamp (|dt v| > radius - 1) and the border clip must both bite
    b = -dt * v
    assert (np.abs(b) > radius - 1).mean() > 0.02
    ii = np.arange(24)[:, None]
    assert ((ii + np.clip(b[:, 0], -1, 1) < 0)
            | (ii + np.clip(b[:, 0], -1, 1) > 23)).any()
    mj, uj = jax_epdiff_step(jnp.asarray(v), jnp.asarray(m), jnp.asarray(u),
                             dt, radius, True)
    with torch.inference_mode():
        mt, ut = epdiff_step(_t(v), _t(m), _t(u), dt, radius)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-5)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-5)


def _k3_inputs(seed=20, shape=(2, 2, 24, 24)):
    """v, m, u and random cotangents (gm', gu') with the in-scan clamp and
    the border clip biting."""
    rng = np.random.default_rng(seed)
    v = _fields(rng, shape, 2.5, 9.0)       # |dt v| up to 1.8 px
    m = _fields(rng, shape, 2.5, 3.0)
    u = _fields(rng, shape, 2.5, 2.0)
    gm = rng.normal(size=shape).astype(np.float32)
    gu = rng.normal(size=shape).astype(np.float32)
    b = -0.2 * v
    assert (np.abs(b) > 1).mean() > 0.02
    ii = np.arange(shape[-2])[:, None]
    cy = ii + np.clip(b[:, 0], -1, 1)
    assert ((cy < 0) | (cy > shape[-2] - 1)).any()
    return v, m, u, gm, gu


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-12)


def test_epdiff_step_bwd_plain_matches_pallas_vjp():
    v, m, u, gm, gu = _k3_inputs()
    _, vjp = jax.vjp(lambda a, b, c: jax_epdiff_step(a, b, c, 0.2, 2, True),
                     jnp.asarray(v), jnp.asarray(m), jnp.asarray(u))
    refs = vjp((jnp.asarray(gm), jnp.asarray(gu)))
    outs = tek._epdiff_step_bwd_plain(*map(_t, (v, m, u, gm, gu)), 0.2, 2)
    for out, ref in zip(outs, refs):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=2e-4, rtol=2e-4)


def test_epdiff_step_bwd_plain_matches_autograd_of_plain_forward():
    v, m, u, gm, gu = (_t(a) for a in _k3_inputs(21))
    leaves = [x.clone().requires_grad_() for x in (v, m, u)]
    mo, uo = tek._epdiff_step_plain(*leaves, 0.2, 2)
    refs = torch.autograd.grad((mo * gm).sum() + (uo * gu).sum(), leaves)
    outs = tek._epdiff_step_bwd_plain(v, m, u, gm, gu, 0.2, 2)
    for out, ref in zip(outs, refs):
        assert _rel(out, ref) < 1e-5


def test_epdiff_step_autograd_runs_the_explicit_backward():
    """EPDiffStep: the explicit adjoint on the CPU, a None cotangent of m'
    taken as zeros."""
    v, m, u, _, gu = (_t(a) for a in _k3_inputs(22))
    leaves = [x.clone().requires_grad_() for x in (v, m, u)]
    _, uo = epdiff_step(*leaves, 0.2, 2)
    grads = torch.autograd.grad((uo * gu).sum(), leaves)
    refs = tek._epdiff_step_bwd_plain(v, m, u, torch.zeros_like(m), gu, 0.2, 2)
    for out, ref in zip(grads, refs):
        np.testing.assert_array_equal(out.numpy(), ref.numpy())


# --------------------------------------------------------------------------- #
# K1: the multi-channel warp's plain version vs the Pallas kernel              #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("channels", [1, 2])
def test_mc_warp_plain_matches_pallas_kernel(channels):
    rng = np.random.default_rng(10 + channels)
    field = _smooth(rng, (2, channels, 32, 32), 2.0, 4.0)
    disp = _fields(rng, (2, 2, 32, 32), 3.0, 15.0)   # up to +-15 px
    assert (np.abs(disp) > 11).mean() > 0.01          # the R-1 clamp bites
    out_j = jax_warp_multi(jnp.asarray(field), jnp.asarray(disp), radius=12,
                           interpret=True)
    with torch.inference_mode():
        out_t = bilinear_warp_banded_multi(_t(field), _t(disp), radius=12)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5)


def _k4_inputs(channels, seed):
    rng = np.random.default_rng(seed)
    field = _smooth(rng, (2, channels, 32, 32), 2.0, 4.0)
    disp = _fields(rng, (2, 2, 32, 32), 3.0, 15.0)   # up to +-15 px
    g = rng.normal(size=field.shape).astype(np.float32)
    assert (np.abs(disp) > 11).mean() > 0.01          # the R-1 clamp bites
    return field, disp, g


@pytest.mark.parametrize("channels", [1, 2])
def test_mc_warp_disp_bwd_plain_matches_pallas_vjp(channels):
    field, disp, g = _k4_inputs(channels, 30 + channels)
    _, vjp = jax.vjp(lambda f, d: _banded_warp_mc(f, d, 12, True, True),
                     jnp.asarray(field), jnp.asarray(disp))
    g_img, g_disp = vjp(jnp.asarray(g))
    assert not np.asarray(g_img).any()        # img_const: no d/d field
    out = twk._mc_warp_disp_bwd_plain(_t(field), _t(disp), _t(g), 12)
    np.testing.assert_allclose(out.numpy(), np.asarray(g_disp),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("channels", [1, 2])
def test_mc_warp_disp_bwd_plain_matches_autograd_of_plain_forward(channels):
    field, disp, g = (_t(a) for a in _k4_inputs(channels, 40 + channels))
    d = disp.clone().requires_grad_()
    ref, = torch.autograd.grad((twk._mc_warp_plain(field, d, 12) * g).sum(),
                               d)
    out = twk._mc_warp_disp_bwd_plain(field, disp, g, 12)
    assert _rel(out, ref) < 1e-5
    # and through the autograd Function of the public wrapper
    d = disp.clone().requires_grad_()
    warped = bilinear_warp_banded_multi(field, d, radius=12, img_const=True)
    got, = torch.autograd.grad((warped * g).sum(), d)
    np.testing.assert_array_equal(got.numpy(), out.numpy())


def test_exact_gather_warp_matches_jax():
    rng = np.random.default_rng(3)
    field = _smooth(rng, (3, 2, 20, 28), 2.0, 4.0)
    disp = _fields(rng, (3, 2, 20, 28), 3.0, 6.0)
    ref = jwarp.warp_vector_field(jnp.asarray(field), jnp.asarray(disp))
    out = twarp.warp_vector_field(_t(field), _t(disp))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


# --------------------------------------------------------------------------- #
# Fluid metric and spectral resize                                             #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("shape", [(3, 2, 24, 20), (1, 2, 136, 132)])
def test_sharp_and_flat_match_jax(shape):
    rng = np.random.default_rng(4)
    x = _smooth(rng, shape, 1.5, 30.0)
    for jf, tf in ((jfm.sharp, tfm.sharp), (jfm.flat, tfm.flat)):
        ref = np.asarray(jf(jnp.asarray(x), 2.0, 1.0, 2))
        out = tf(_t(x), 2.0, 1.0, 2).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("src,dst", [((32, 24), (16, 12)), ((16, 12), (32, 24)),
                                     ((15, 16), (30, 9)),
                                     ((136, 130), (68, 65))])
def test_spectral_resize_matches_jax(src, dst):
    rng = np.random.default_rng(5)
    x = _smooth(rng, (2, 2) + src, 1.5, 2.0)
    ref = np.asarray(jfm.spectral_resize(jnp.asarray(x), dst))
    out = tfm.spectral_resize(_t(x), dst).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


# --------------------------------------------------------------------------- #
# Subspace smoothing                                                            #
# --------------------------------------------------------------------------- #

def test_stored_start_matrix_is_jax_draw():
    for t in (40, 16):      # the flagship's Ts, and the large-frame cell's
        ref = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (t, 5),
                                           jnp.float32))
        np.testing.assert_array_equal(tsvd.start_matrix(t, 5).numpy(), ref)
    for shape in ((41, 5), (16, 4)):
        with pytest.raises(NotImplementedError):
            tsvd.start_matrix(*shape)


def test_subspace_denoise_matches_jax():
    rng = np.random.default_rng(6)
    low = rng.normal(size=(3, 126, 7)) @ rng.normal(size=(3, 7, 40))
    x = (0.1 * low + 0.01 * rng.normal(size=(3, 126, 40))).astype(np.float32)
    ref = np.asarray(jsvd.subspace_denoise(jnp.asarray(x), 5, n_iters=4))
    out = tsvd.subspace_denoise(_t(x), 5, n_iters=4).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


# --------------------------------------------------------------------------- #
# Shooting                                                                     #
# --------------------------------------------------------------------------- #

def _momentum(seed, shape=(3, 2, 32, 32), scale=20.0):
    return _fields(np.random.default_rng(seed), shape, 3.0, scale)


def test_expmap_shooting_downsampled_matches_fused_jax(monkeypatch):
    # the fused interpret path is the only JAX CPU path with the in-scan
    # clamp (the default CPU path warps by the unclamped gather)
    monkeypatch.setattr(jax_shooting, "_FORCE_FUSED", True)
    m0 = _momentum(7)
    uj, vj, lj = jax_shooting.expmap_shooting(
        jnp.asarray(m0), n_steps=5, warp_radius=8, shoot_downsample=2,
        return_low=True)
    with torch.inference_mode():
        ut, vt, lt = tshooting.expmap_shooting(
            _t(m0), n_steps=5, warp_radius=8, shoot_downsample=2,
            return_low=True)
    # the in-scan clamp |dt v| <= 1 px bites on this momentum
    v_low = tfm.sharp(tfm.spectral_resize(_t(m0), (16, 16)) / 2, 0.5)
    assert (0.2 * v_low.abs() > 1.0).any()
    # f32 roundoff through 5 chained steps, amplified where the clamp bites
    # (displacements reach ~80 px there): 1e-4 + 1e-5 * max|u| absolute
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-5)
    for out, ref in ((ut, uj), (lt, lj)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(out.numpy(), ref,
                                   atol=1e-4 + 1e-5 * np.abs(ref).max())


def test_expmap_shooting_exact_path_matches_jax():
    m0 = _momentum(8, shape=(2, 2, 24, 24), scale=10.0)
    uj, vj = jax_shooting.expmap_shooting(jnp.asarray(m0), n_steps=3,
                                          warp_radius=None)
    ut, vt = tshooting.expmap_shooting(_t(m0), n_steps=3, warp_radius=None)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-4)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-5)
