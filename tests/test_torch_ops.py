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
from torch_budget import time_limit  # noqa: F401


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


def _k4_inputs(channels, seed, hw=(32, 32)):
    rng = np.random.default_rng(seed)
    field = _smooth(rng, (2, channels, *hw), 2.0, 4.0)
    disp = _fields(rng, (2, 2, *hw), 3.0, 15.0)      # up to +-15 px
    g = rng.normal(size=field.shape).astype(np.float32)
    assert (np.abs(disp) > 11).mean() > 0.01          # the R-1 clamp bites
    return field, disp, g


# the last case sums three channels in the band sweep's order on a
# non-square frame whose width is no multiple of 4
@pytest.mark.parametrize("channels, hw, seed", [
    pytest.param(1, (32, 32), 31, id="1"),
    pytest.param(2, (32, 32), 32, id="2"),
    pytest.param(3, (30, 37), 33, id="3-30x37")])
def test_mc_warp_disp_bwd_plain_matches_pallas_vjp(channels, hw, seed):
    field, disp, g = _k4_inputs(channels, seed, hw)
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

# jax.random.normal(jax.random.PRNGKey(0), (40, 5), jnp.float32), as the
# port stored it until it generated the draw itself
_START_40x5 = [
    [1.6226422, 2.0252647, -0.43359444, -0.07861735, 0.1760909],
    [-0.97208923, -0.49529874, 0.4943786, 0.6643493, -0.9501635],
    [2.1795304, -1.9551506, 0.35857072, 0.15779513, 1.2770847],
    [1.5104648, 0.970656, 0.59960806, 0.024700705, -1.9164772],
    [-1.8593491, 1.728144, 0.04719035, 0.814128, 0.13132767],
    [0.28284705, 1.2435943, 0.6902801, -0.80073744, -0.74099],
    [-1.5388287, 0.30269185, -0.020716045, 0.11328721, -0.2206547],
    [0.07052256, 0.8532958, -0.8217738, -0.014614211, -0.15046217],
    [-0.9001352, -0.7590727, 0.33309513, 0.80924904, 0.042692553],
    [-0.57767123, -0.41439894, -1.9412533, 1.3161184, 0.7542728],
    [0.16170931, -0.03483307, -1.3306409, 0.39362028, 0.48259583],
    [0.80382955, -0.6337168, 1.038756, -0.74159133, -0.4299588],
    [-0.22510043, -0.51966715, -1.6692165, 0.67535436, 0.22738722],
    [-1.1800426, -0.97673357, 1.1969604, -0.84127563, 0.6598078],
    [1.0680159, 0.31542128, 0.43766403, 1.1718564, 0.9077099],
    [1.2226242, -0.54639524, 0.85630435, -0.007965775, 0.47343913],
    [-1.1090349, 2.6423514, 0.88957626, 0.9952015, 0.2551972],
    [0.124961376, 1.164173, 0.19296366, -0.19099544, -0.43659472],
    [-1.1461989, 0.19760251, 1.1686655, -0.8733985, 0.8818086],
    [-0.3441057, -0.14614972, -0.91352165, 1.370097, -0.7800775],
    [0.36481506, 0.9761402, -0.007172703, 0.21052206, 0.19035842],
    [0.38291267, -1.2656332, -1.4843545, -0.114543624, 1.1037136],
    [0.19846702, 0.21388935, -0.6605348, -0.72722006, 0.40443972],
    [0.18965738, -0.6031794, 0.9450588, 1.0838778, -2.0560737],
    [-0.71382153, 0.59286827, 1.0507762, -1.4646238, 0.66001135],
    [-0.30172178, 0.13313177, -0.33281323, 1.5700098, 0.5745121],
    [0.7234155, 0.6966845, -0.66423434, -1.9669566, -2.4162543],
    [0.27330154, 1.1603173, 0.2655127, 0.6909093, -0.2560643],
    [-2.0227401, -0.6231289, 0.2795317, -1.3503172, 0.10128845],
    [0.51268137, 0.2640195, -1.8291276, 1.4337775, 1.3188555],
    [-1.4953226, 0.93327594, 1.4092648, -0.16788375, -0.11862286],
    [-0.2428249, -0.96175927, -0.75636, 2.5728257, -1.0601792],
    [0.31232905, 0.3275118, 0.08283223, -1.0826886, -0.7722345],
    [-0.63460463, 1.2264103, -1.487015, -0.79286903, 0.5531185],
    [-1.1855397, 0.9769094, -0.43845034, -0.329756, 0.33254716],
    [-0.6527196, -1.2052122, -0.88630825, -2.1088374, -0.15503536],
    [-0.65793204, -0.663254, -0.03336205, -0.8959291, 0.0771168],
    [-0.909823, 1.276052, -0.40167663, -0.99992526, 0.017341979],
    [0.40454188, -1.0713243, 1.0366626, -0.6684805, -0.07793187],
    [1.2080221, 2.0031455, -0.07060029, 0.33603913, 2.354045],
]


def _ulps(a, b):
    """Distance in f32 units in the last place (same-sign floats)."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_stored_start_matrix_is_jax_draw():
    # the flagship's (40, 5) and its stored literal; the large-frame cell's
    # Ts = 16; a T above 40; ranks other than 5
    stored = np.asarray(_START_40x5, np.float32)
    np.testing.assert_array_equal(
        np.asarray(jax.random.normal(jax.random.PRNGKey(0), (40, 5),
                                     jnp.float32)), stored)
    # the flagship's and the large-frame cell's draws stay bit-equal, as
    # when they were stored
    np.testing.assert_array_equal(tsvd.start_matrix(40, 5).numpy(), stored)
    np.testing.assert_array_equal(tsvd.start_matrix(16, 5).numpy(),
                                  stored[:16])
    for shape in ((41, 5), (16, 4), (12, 3), (100, 8)):
        ref = np.asarray(jax.random.normal(jax.random.PRNGKey(0), shape,
                                           jnp.float32))
        out = tsvd.start_matrix(*shape).numpy()
        assert out.shape == shape and out.dtype == np.float32
        assert np.all(np.sign(out) == np.sign(ref))
        assert _ulps(out, ref).max() <= 2, shape      # erfinv: an ulp or two


def test_subspace_denoise_matches_jax():
    rng = np.random.default_rng(6)
    low = rng.normal(size=(3, 126, 7)) @ rng.normal(size=(3, 7, 40))
    x = (0.1 * low + 0.01 * rng.normal(size=(3, 126, 40))).astype(np.float32)
    ref = np.asarray(jsvd.subspace_denoise(jnp.asarray(x), 5, n_iters=4))
    out = tsvd.subspace_denoise(_t(x), 5, n_iters=4).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("rank,t", [(3, 40), (4, 16), (8, 100)])
def test_subspace_denoise_other_ranks_match_jax(rank, t):
    rng = np.random.default_rng(16)
    low = rng.normal(size=(2, 126, 7)) @ rng.normal(size=(2, 7, t))
    x = (0.1 * low + 0.01 * rng.normal(size=(2, 126, t))).astype(np.float32)
    ref = np.asarray(jsvd.subspace_denoise(jnp.asarray(x), rank, n_iters=4))
    out = tsvd.subspace_denoise(_t(x), rank, n_iters=4).numpy()
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
