"""The fused-solve EPDiff step (K6/K7) and ``expmap_shooting``'s options,
held against the JAX package on CPU.

The same numpy inputs go through the JAX function and its port. The port
runs on CPU tensors, so ``epdiff_step_solve`` takes its plain PyTorch
versions; the Pallas kernels ``_fwd_solve_kernel``/``_bwd_solve_kernel``
run in interpret mode, as ``tests/test_ops.py::TestFusedSolveEPDiffStep``
runs them. Tolerances are those of the JAX suite: 1e-5 for one step's
values, 2e-4 for its gradients against ``jax.vjp``, 1e-4 + 1e-5 max|u| and
2e-3 for three chained steps; inside the port (the same arithmetic in
another order) 1e-5 of the range for values and 1e-4 relative L2 for
gradients.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

import cardiax.ops as jops
import cardiax.ops.shooting as jax_shooting
from cardiax.ops import fluid_metric as jfm
from cardiax.ops.epdiff_pallas import epdiff_step_solve as jax_step_solve
import cardiax_torch.ops as tops
from cardiax_torch.ops import epdiff_kernels as tek
from cardiax_torch.ops import fluid_metric as tfm
from cardiax_torch.ops import shooting as tsh
from torch_budget import time_limit  # noqa: F401

METRIC = (0.5, 1.0, 2)      # the flagship's metric on its 64^2 grid


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _fields(rng, shape, sigma, scale):
    """A smooth field normalised to a max |value| of ``scale``."""
    f = ndimage.gaussian_filter(rng.normal(size=shape), (0, 0, sigma, sigma))
    return (f / np.abs(f).max() * scale).astype(np.float32)


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-12)


def _rel_l2(out, ref):
    return ((out - ref).norm() / ref.norm()).item()


def _step_inputs(seed, shape, radius, dt=0.2):
    """m, u, gm', gu' with v = K m reaching |dt v| = radius - 0.2 px, so
    that the in-scan clamp at radius - 1 and the border clip both bite."""
    rng = np.random.default_rng(seed)
    m = _fields(rng, shape, 2.5, 1.0)
    v = tek._solve_plain(_t(m), *_port_operands(*shape[-2:]))
    m = (m * (radius - 0.2) / (dt * v.abs().max().item())).astype(np.float32)
    b = -dt * tek._solve_plain(_t(m), *_port_operands(*shape[-2:])).numpy()
    assert (np.abs(b) > radius - 1).mean() > 0.005
    ii = np.arange(shape[-2])[:, None]
    cy = ii + np.clip(b[:, 0], 1 - radius, radius - 1)
    assert ((cy < 0) | (cy > shape[-2] - 1)).any()
    u = _fields(rng, shape, 2.5, 2.0)
    gm = rng.normal(size=shape).astype(np.float32)
    gu = rng.normal(size=shape).astype(np.float32)
    return m, u, gm, gu


def _jax_operands(h, w):
    return jfm.solve_mm_operands(h, w, 1, 1, *METRIC)


def _port_operands(h, w):
    return tek._solve_operands(h, w, *METRIC, "cpu")


# --------------------------------------------------------------------------- #
# The ops' signatures (the remat repair) and the operands of the solve        #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", tops.__all__)
def test_port_ops_have_the_jax_signatures(name):
    """Every name the port exports takes JAX's parameters, in JAX's order,
    with JAX's defaults: ``expmap_shooting`` lacked ``remat`` (a positional
    ``return_low`` landed on it)."""
    def params(fn):
        return [(p.name, p.default)
                for p in inspect.signature(fn).parameters.values()]
    assert params(getattr(tops, name)) == params(getattr(jops, name))


@pytest.mark.parametrize("hw", [(24, 24), (16, 32)])
def test_solve_mm_operands_match_jax(hw):
    """JAX's five operands (ty, txT, tyT, tx, wgt), in JAX's order, from
    JAX's positional arguments."""
    port = tfm.solve_mm_operands(*hw, 1, 1, *METRIC)
    ref = _jax_operands(*hw)
    assert len(port) == len(ref) == 5
    for out, want in zip(port, ref):
        assert tuple(out.shape) == tuple(want.shape)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-7,
                                   rtol=0)


def test_fluid_metric_matches_jax():
    x = _fields(np.random.default_rng(1), (2, 2, 24, 20), 1.5, 10.0)
    jm, tm = jfm.FluidMetric(*METRIC), tfm.FluidMetric(*METRIC)
    for jf, tf in ((jm.sharp, tm.sharp), (jm.flat, tm.flat)):
        ref = np.asarray(jf(jnp.asarray(x)))
        np.testing.assert_allclose(tf(_t(x)).numpy(), ref,
                                   atol=1e-5 * np.abs(ref).max())


# --------------------------------------------------------------------------- #
# K6/K7's plain versions vs the Pallas kernels (interpret mode)                #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("shape", [(2, 2, 24, 24), (2, 2, 16, 24)])
@pytest.mark.parametrize("radius", [2, 3])
def test_step_solve_plain_matches_pallas_kernel(shape, radius):
    m, u, _, _ = _step_inputs(10 + radius, shape, radius)
    mj, uj = jax_step_solve(jnp.asarray(m), jnp.asarray(u),
                            *_jax_operands(*shape[-2:]), 0.2, radius, True)
    with torch.inference_mode():
        mt, ut = tek.epdiff_step_solve(_t(m), _t(u), 0.2, radius, *METRIC)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-5)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-5)


def test_step_solve_bwd_plain_matches_pallas_vjp():
    # a plane with H != W, so a swapped Ty/Tx shows
    shape, radius = (2, 2, 16, 24), 2
    m, u, gm, gu = _step_inputs(22, shape, radius)
    ops = _jax_operands(*shape[-2:])
    _, vjp = jax.vjp(lambda a, b: jax_step_solve(a, b, *ops, 0.2, radius,
                                                 True),
                     jnp.asarray(m), jnp.asarray(u))
    refs = vjp((jnp.asarray(gm), jnp.asarray(gu)))
    outs = tek._epdiff_step_solve_bwd_plain(
        _t(m), _t(u), *_port_operands(*shape[-2:]), _t(gm), _t(gu), 0.2,
        radius)
    for out, ref in zip(outs, refs):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("radius", [2, 3])
def test_step_solve_bwd_plain_matches_autograd_of_plain_forward(radius):
    m, u, gm, gu = (_t(a) for a in _step_inputs(30, (2, 2, 24, 20), radius))
    ops = _port_operands(24, 20)
    leaves = [x.clone().requires_grad_() for x in (m, u)]
    mo, uo = tek._epdiff_step_solve_plain(*leaves, *ops, 0.2, radius)
    refs = torch.autograd.grad((mo * gm).sum() + (uo * gu).sum(), leaves)
    outs = tek._epdiff_step_solve_bwd_plain(m, u, *ops, gm, gu, 0.2, radius)
    for out, ref in zip(outs, refs):
        assert _rel(out, ref) < 1e-5
    # and through the autograd Function of the public wrapper
    leaves = [x.clone().requires_grad_() for x in (m, u)]
    mo, uo = tek.epdiff_step_solve(*leaves, 0.2, radius, *METRIC)
    got = torch.autograd.grad((mo * gm).sum() + (uo * gu).sum(), leaves)
    for out, ref in zip(got, outs):
        np.testing.assert_array_equal(out.numpy(), ref.numpy())


def test_step_solve_saves_only_m_and_u():
    m, u, _, _ = (_t(a) for a in _step_inputs(31, (2, 2, 16, 16), 2))
    m, u = m.requires_grad_(), u.requires_grad_()
    mo, _ = tek.epdiff_step_solve(m, u, 0.2, 2, *METRIC)
    saved = mo.grad_fn.saved_tensors
    assert len(saved) == 2
    assert torch.equal(saved[0], m) and torch.equal(saved[1], u)


def test_step_solve_refusals():
    z = torch.zeros(2, 2, 8, 8)
    ops = _port_operands(8, 8)
    with pytest.raises(RuntimeError, match="not a CUDA tensor"):
        tek._epdiff_step_solve_cuda(z, z, *ops, 0.2, 2)
    with pytest.raises(RuntimeError, match="not a CUDA tensor"):
        tek._epdiff_step_solve_bwd_cuda(z, z, *ops, z, z, 0.2, 2)
    small = torch.zeros(1, 2, 3, 8)
    with pytest.raises(ValueError, match="H, W >= 4"):
        tek.epdiff_step_solve_bwd(small, small, *_port_operands(3, 8), small,
                                  small, 0.2, 2)
    m, u = (torch.zeros(1, 2, 8, 3).requires_grad_() for _ in range(2))
    _, uo = tek.epdiff_step_solve(m, u, 0.2, 2, *METRIC)   # forward runs
    with pytest.raises(ValueError, match="H, W >= 4"):
        uo.sum().backward()
    with pytest.raises(TypeError, match="float32"):
        tek.epdiff_step_solve(z.double(), z.double(), 0.2, 2)
    with pytest.raises(ValueError, match=r"\(N, 2, H, W\)"):
        tek.epdiff_step_solve(z, torch.zeros(2, 2, 8, 4), 0.2, 2)


# --------------------------------------------------------------------------- #
# expmap_shooting with the fused solve                                         #
# --------------------------------------------------------------------------- #

def _momentum(seed, shape, scale=20.0):
    return _fields(np.random.default_rng(seed), shape, 4.0, scale)


def _counting(monkeypatch, name):
    """Replace ``shooting.<name>`` by a wrapper that counts its calls."""
    calls = []
    real = getattr(tsh, name)

    def wrapper(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)
    monkeypatch.setattr(tsh, name, wrapper)
    return calls


def _shoot(m0, **kwargs):
    """(u_inv, d sum(u_inv^2) / d m0) of the port's expmap_shooting."""
    m = _t(m0).requires_grad_()
    u, _ = tsh.expmap_shooting(m, **kwargs)
    g, = torch.autograd.grad((u ** 2).sum(), m)
    return u.detach(), g


def test_fused_solve_shooting_matches_jax(monkeypatch):
    m0 = _momentum(7, (5, 2, 32, 32))
    kw = dict(n_steps=3, warp_radius=8, shoot_downsample=2)
    monkeypatch.setattr(jax_shooting, "_FORCE_FUSED", True)
    monkeypatch.setattr(jax_shooting, "_FUSED_SOLVE", True)

    def loss(m):
        u = jax_shooting.expmap_shooting(m, **kw)[0]
        return jnp.sum(u ** 2), u
    (_, uj), gj = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(m0))
    monkeypatch.setattr(tsh, "_FUSED_SOLVE", True)
    calls = _counting(monkeypatch, "epdiff_step_solve")
    ut, gt = _shoot(m0, **kw)
    assert calls == [(5, 2, 16, 16)] * 3
    uj, gj = np.asarray(uj), np.asarray(gj)
    # the in-scan clamp |dt v| <= 1 px bites on this momentum
    v_low = tfm.sharp(tfm.spectral_resize(_t(m0), (16, 16)) / 2, *METRIC)
    assert (v_low.abs() / 3 > 1.0).any()
    np.testing.assert_allclose(ut.numpy(), uj,
                               atol=1e-4 + 1e-5 * np.abs(uj).max())
    np.testing.assert_allclose(gt.numpy(), gj, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("ds", [1, 2])
def test_fused_solve_equals_separate_solve(monkeypatch, ds):
    m0 = _momentum(8, (3, 2, 32, 32))
    kw = dict(n_steps=3, warp_radius=8, shoot_downsample=ds)
    u_s, g_s = _shoot(m0, **kw)
    monkeypatch.setattr(tsh, "_FUSED_SOLVE", True)
    calls = _counting(monkeypatch, "epdiff_step_solve")
    u_f, g_f = _shoot(m0, **kw)
    assert len(calls) == 3
    assert _rel(u_f, u_s) < 1e-5
    assert _rel_l2(g_f, g_s) < 1e-4


@pytest.mark.parametrize("side,fused", [(128, True), (136, False)])
def test_fused_solve_engages_up_to_128_px(monkeypatch, side, fused):
    """Up to 128 px a side the fused solve runs (JAX's cap is on the packed
    plane; the port does not pack); above, the separate solve, which the
    flag then leaves untouched."""
    m0 = _momentum(9, (1, 2, side, side), 30.0)
    with torch.inference_mode():
        u_off, _ = tsh.expmap_shooting(_t(m0), n_steps=2, warp_radius=8)
        monkeypatch.setattr(tsh, "_FUSED_SOLVE", True)
        calls = _counting(monkeypatch, "epdiff_step_solve")
        u_on, _ = tsh.expmap_shooting(_t(m0), n_steps=2, warp_radius=8)
    assert len(calls) == (2 if fused else 0)
    if fused:
        assert _rel(u_on, u_off) < 1e-5
    else:
        np.testing.assert_array_equal(u_on.numpy(), u_off.numpy())


@pytest.mark.parametrize("fused", [False, True])
def test_remat_equals_no_remat(monkeypatch, fused):
    """``remat=True`` recomputes each step in the backward (the step runs
    twice as often) and changes no value or gradient."""
    monkeypatch.setattr(tsh, "_FUSED_SOLVE", fused)
    calls = _counting(monkeypatch,
                      "epdiff_step_solve" if fused else "epdiff_step")
    m0 = _momentum(10, (2, 2, 24, 24))
    u0, g0 = _shoot(m0, n_steps=3, warp_radius=8)
    assert len(calls) == 3
    u1, g1 = _shoot(m0, n_steps=3, warp_radius=8, remat=True)
    assert len(calls) == 3 + 6
    np.testing.assert_array_equal(u1.numpy(), u0.numpy())
    assert _rel_l2(g1, g0) < 1e-6
