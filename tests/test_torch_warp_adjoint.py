"""K5's function on the CPU: the warp's adjoint at its hard cases.

``_mc_warp_fused_bwd_plain`` (the plain version that kernel K5 is held
against on the card) is held here against an independent float64 scatter:
``index_add_`` of g * w to the four taps of the forward's ``sample_coords``
(``cardiax_torch/ops/warp.py``), where two taps that coincide at the clip
add both their weights. The cases are ``test_torch_kernels.k5_case``'s: a
convergent field (the longest lists of sources a tap), the clip holding
whole rows and columns, integer displacements, and frames that are no
multiple of the kernel's tile or narrower than a warp; at C = 1, 2, 5.
Tolerance: 1e-5 of the output's range (f32 against f64). One convergent
case is held against the Pallas B5 VJP in interpret mode (1e-4, the
gradient tolerance of ``tests/test_ops.py``) at 32^2, C=2 and R=8: the
interpret-mode sweep unrolls (2R+1)^2 taps a channel, so R=12 takes 25 s
to build on the CPU and R=8 10 s, with 15^2 sources sharing a tap.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cardiax.ops.warp_pallas as wp
from cardiax_torch.ops import warp_kernels as twk
from cardiax_torch.ops.warp import sample_coords
from test_torch_kernels import K5_CASES, k5_case
from torch_budget import time_limit  # noqa: F401


def _scatter_adjoint(field, disp, g, radius):
    """d/d field of sum(g * warp(field, disp)) in float64: each source adds
    g * w to its four taps."""
    n, c, h, w = field.shape
    d = torch.from_numpy(disp).double()
    gg = torch.from_numpy(g).double().reshape(n, c, h * w)
    taps, fy, fx = sample_coords(d[:, 0], d[:, 1], float(radius - 1))
    fy, fx = fy.reshape(n, h * w), fx.reshape(n, h * w)
    weights = ((1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx)
    out = torch.zeros((n, c, h * w), dtype=torch.float64)
    for tap, wt in zip(taps, weights):
        for i in range(n):
            out[i].index_add_(1, tap[i], gg[i] * wt[i])
    return out.reshape(n, c, h, w)


@pytest.mark.parametrize("channels", [1, 2, 5])
@pytest.mark.parametrize("kind", list(K5_CASES))
def test_fused_bwd_plain_matches_float64_scatter(kind, channels):
    field, disp, g, radius = k5_case(kind, channels, seed=channels)
    r = radius - 1
    if kind == "clip":       # whole last rows and columns held by the clip
        h, w = disp.shape[-2:]
        assert (np.arange(h)[:, None] + np.minimum(disp[:, 0], r)
                > h - 1).all(axis=-1).any()
        assert (np.arange(w) + np.minimum(disp[:, 1], r)
                > w - 1).all(axis=-2).any()
    if kind == "integer":
        assert (disp == np.round(disp)).all() and (np.abs(disp) > r).any()
    ref = _scatter_adjoint(field, disp, g, radius)
    got, _ = twk._mc_warp_fused_bwd_plain(
        *(torch.from_numpy(a) for a in (field, disp, g)), radius,
        with_disp=False)
    if kind == "convergent":  # a tap shared by many sources
        ones = np.ones_like(g[:, :1])
        assert _scatter_adjoint(ones, disp, ones, radius).max() > 100
    err = (got.double() - ref).abs().max().item()
    assert err <= 1e-5 * max(1.0, ref.abs().max().item()), err


def test_fused_bwd_plain_matches_pallas_vjp_on_convergent_field():
    rng = np.random.default_rng(95)
    h = w = 32
    centre = rng.uniform(-0.5, 0.5, size=(1, 2, 1, 1))
    ii, jj = np.arange(h).reshape(1, h, 1), np.arange(w).reshape(1, 1, w)
    disp = np.stack(np.broadcast_arrays(
        (h - 1) / 2 + centre[:, 0] - ii, (w - 1) / 2 + centre[:, 1] - jj),
        axis=1).astype(np.float32)
    field = rng.normal(size=(1, 2, h, w)).astype(np.float32)
    g = rng.normal(size=field.shape).astype(np.float32)
    # the VJP rule of wp._banded_warp_mc (B5 in interpret mode), without
    # its forward
    g_field, g_disp = wp._mc_bwd(8, True, False, (jnp.asarray(field),
                                                   jnp.asarray(disp)),
                                 jnp.asarray(g))
    out_f, out_d = twk._mc_warp_fused_bwd_plain(
        *(torch.from_numpy(a) for a in (field, disp, g)), 8)
    np.testing.assert_allclose(out_f.numpy(), np.asarray(g_field),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out_d.numpy(), np.asarray(g_disp),
                               atol=1e-4, rtol=1e-4)
