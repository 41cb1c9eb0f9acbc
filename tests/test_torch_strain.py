"""The analytic strain path of the port against the JAX package, on CPU.

``cardiax_torch/ops/strain.py`` (the four strain ops), ``svd_denoise`` and
``JointRegisterStrainMatNet(strainmat_net_type="analytic")`` against their
``cardiax`` counterparts on the same seeded numpy inputs: the ops within
1e-5 of the output's range, ``circumferential_strain``'s gradient against
``jax.grad`` within 1e-4 of its range, the analytic network against flax on
carried weights (a seeded momentum head, so the displacements and the strain
are not zero) at the eval step's bf16-level tolerance, and the analytic
network's param tree through ``params_from_flax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cardiax.ops.shooting as jax_shooting
import cardiax.ops.strain as jstrain
import cardiax.ops.svd_smooth as jsvd
import cardiax_torch.ops.strain as tstrain
import cardiax_torch.ops.svd_smooth as tsvd
from cardiax.models import build_model as jax_build_model
from cardiax_torch.data.synthetic import make_dataset
from cardiax_torch.io.convert import params_from_flax
from cardiax_torch.models import build_model, init_weights
from torch_budget import time_limit  # noqa: F401

H = W = 24
T = 5
S = 126


def _masks(n, seed):
    """(n, H, W) frame-0 myocardium masks of synthetic slices."""
    data = make_dataset(n_subjects=n, slices_per_subject=1, h=H, w=W,
                        n_frames=3, seed=seed)
    return np.stack([d["cine_lv_myo_masks"][..., 0] for d in data]
                    ).astype(np.float32)


def _disp(rng, n):
    """(n, 2, T, H, W) smooth Lagrangian displacements of about 1 px."""
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    out = np.zeros((n, 2, T, H, W), np.float32)
    for idx in np.ndindex(n, 2, T):
        a, b, c, d = rng.normal(size=4)
        out[idx] = a * np.sin(yy / 5.0 + b) + c * np.cos(xx / 4.0 + d)
    return out


def _range_err(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-6)


def test_mask_centroid_matches_jax():
    masks = _masks(3, 1)
    for m in masks:
        ref = jstrain.mask_centroid(jnp.asarray(m))
        out = tstrain.mask_centroid(torch.from_numpy(m))
        for o, r in zip(out, ref):
            assert o.shape == ()
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6)
    # batched: one call for every mask; empty masks stay finite
    batch = np.concatenate([masks, np.zeros((1, H, W), np.float32)])
    cy, cx = tstrain.mask_centroid(torch.from_numpy(batch))
    assert cy.shape == (4,) and torch.isfinite(cy).all()
    for i, m in enumerate(batch):
        ry, rx = jstrain.mask_centroid(jnp.asarray(m))
        np.testing.assert_allclose([cy[i].item(), cx[i].item()],
                                   [float(ry), float(rx)], rtol=1e-6)


@pytest.mark.parametrize("n_sectors", [126, 16])
def test_sector_matrix_matches_jax(n_sectors):
    masks = _masks(3, 2)
    out = tstrain.sector_matrix(torch.from_numpy(masks), n_sectors).numpy()
    assert out.shape == (3, n_sectors, H * W)
    for i, m in enumerate(masks):
        ref = np.asarray(jstrain.sector_matrix(jnp.asarray(m), n_sectors))
        np.testing.assert_array_equal(out[i], ref)


def test_circumferential_strain_matches_jax():
    rng = np.random.default_rng(3)
    masks, disp = _masks(2, 3), _disp(rng, 2)
    out = tstrain.circumferential_strain(torch.from_numpy(disp[0]),
                                         torch.from_numpy(masks[0])).numpy()
    ref = np.asarray(jstrain.circumferential_strain(jnp.asarray(disp[0]),
                                                    jnp.asarray(masks[0])))
    assert out.shape == ref.shape == (S, T)
    assert np.abs(ref).max() > 1e-2
    assert _range_err(out, ref) < 1e-5


def test_strain_matrix_from_displacements_matches_jax():
    rng = np.random.default_rng(4)
    masks, disp = _masks(3, 4), _disp(rng, 3)
    ref = np.asarray(jstrain.strain_matrix_from_displacements(
        jnp.asarray(disp), jnp.asarray(masks), 32))
    out = tstrain.strain_matrix_from_displacements(
        torch.from_numpy(disp), torch.from_numpy(masks), 32).numpy()
    assert out.shape == ref.shape == (3, 32, T)
    assert _range_err(out, ref) < 1e-5


def test_circumferential_strain_gradient_matches_jax():
    rng = np.random.default_rng(5)
    mask, disp = _masks(1, 5)[0], _disp(rng, 1)[0]
    w = rng.normal(size=(S, T)).astype(np.float32)
    ref = np.asarray(jax.grad(lambda d: jnp.sum(
        jstrain.circumferential_strain(d, jnp.asarray(mask))
        * jnp.asarray(w)))(jnp.asarray(disp)))
    d = torch.from_numpy(disp).requires_grad_(True)
    (tstrain.circumferential_strain(d, torch.from_numpy(mask))
     * torch.from_numpy(w)).sum().backward()
    assert np.abs(ref).max() > 1e-3
    assert _range_err(d.grad.numpy(), ref) < 1e-4


def test_svd_denoise_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, S, 12)).astype(np.float32)
    for rank in (3, 5):
        # numpy in: the same numpy code in both packages
        ref = jsvd.svd_denoise(x, rank)
        out = tsvd.svd_denoise(x, rank)
        assert isinstance(out, np.ndarray)
        np.testing.assert_array_equal(out, ref)
        # a tensor: torch.linalg.svd against jnp.linalg.svd
        ref = np.asarray(jsvd.svd_denoise(jnp.asarray(x), rank))
        out = tsvd.svd_denoise(torch.from_numpy(x), rank).numpy()
        assert _range_err(out, ref) < 1e-5
        assert np.linalg.matrix_rank(out[0].astype(np.float64),
                                     tol=1e-4) == rank


# --------------------------------------------------------------------------- #
# The analytic network                                                          #
# --------------------------------------------------------------------------- #

NET = {"type": "JointRegisterStrainMatNet", "strainmat_net_type": "analytic",
       "n_strain_matrix_frames": 8, "reg_features": 4,
       "n_integration_steps": 2}
T_MYO = 4


def _volumes():
    """src/tar (B, 1, T_MYO-1, 32, 32) Lagrangian pairs of synthetic
    slices."""
    data = make_dataset(n_subjects=2, slices_per_subject=1, h=32, w=32,
                        n_frames=T_MYO, seed=7)
    vol = np.moveaxis(np.stack([d["cine_lv_myo_masks"] for d in data]),
                      -1, 1)[:, None].astype(np.float32)
    src = np.broadcast_to(vol[:, :, :1], vol[:, :, 1:].shape).copy()
    return src, np.ascontiguousarray(vol[:, :, 1:])


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture(scope="module")
def analytic_pair():
    """(src, tar, flax outputs, flax params) with a seeded momentum head."""
    src, tar = _volumes()
    bundle = jax_build_model(NET)
    params = _np_tree(jax.jit(bundle.module.init)(
        jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(tar)))
    head = params["params"]["momentum_unet"]["Conv_0"]
    rng = np.random.default_rng(8)
    for k in ("kernel", "bias"):
        head[k] = (rng.normal(size=head[k].shape) * 0.02).astype(np.float32)
    # the fused interpret scan carries the in-scan clamp of the port's
    # kernel; the final warp takes JAX's unclamped CPU gather, so the
    # displacements must stay below the 11 px clamp (asserted below)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_shooting, "_FORCE_FUSED", True)
        out = jax.tree_util.tree_map(np.asarray, bundle.module.apply(
            params, jnp.asarray(src), jnp.asarray(tar)))
    return src, tar, out, params


def test_params_from_flax_carries_the_analytic_tree(analytic_pair):
    params = analytic_pair[3]
    assert set(params["params"]) == {"momentum_unet"}      # no strain_head
    state = params_from_flax({"net": params})["net"]
    assert len(state) == len(jax.tree_util.tree_leaves(params))
    net = build_model(NET).module                          # no n_pairs needed
    assert net.strain_head is None
    assert set(state) == set(net.state_dict())
    net.load_state_dict(state)


def test_analytic_net_matches_flax(analytic_pair):
    src, tar, ref, params = analytic_pair
    net = build_model(NET, n_pairs=T_MYO - 1).module
    net.load_state_dict(params_from_flax({"net": params})["net"])
    with torch.inference_mode():
        out = net(torch.from_numpy(src), torch.from_numpy(tar))
    disp = out["displacement"].numpy()
    assert 0.05 < np.abs(disp).max() < 11.0
    assert np.abs(ref["strain_matrix"]).max() > 1e-3
    # bf16 momentum UNet: the eval step's tolerances (test_torch_models.py)
    for k, tol in (("displacement", 5e-2), ("strain_matrix", 5e-2),
                   ("deformed_source", 5e-2)):
        assert out[k].shape == ref[k].shape, k
        assert _range_err(out[k].numpy(), ref[k]) < tol, k
    assert out["strain_matrix"].shape == (2, 1, S, NET["n_strain_matrix_frames"])
    # the strain is the op's on the network's own full-resolution
    # displacements, resampled to the strain frames and smoothed
    strain_p = tstrain.strain_matrix_from_displacements(
        out["displacement"].transpose(1, 2), torch.from_numpy(src[:, 0, 0]))
    raw = net._analytic_strain(out["displacement"],
                               torch.from_numpy(src[:, 0, 0]))
    assert torch.allclose(raw[..., -1], strain_p[..., -1], atol=1e-7)
    assert torch.equal(raw[..., 0], torch.zeros_like(raw[..., 0]))


def test_analytic_hat_matrix_matches_jax():
    """The (P, Ts) resample alone: JAX's ``_analytic_strain`` against the
    port's on the same displacements and masks."""
    rng = np.random.default_rng(9)
    masks, disp = _masks(2, 9), _disp(rng, 2)
    video = np.ascontiguousarray(np.moveaxis(disp, 1, 2))   # (B, P, 2, H, W)
    bundle = jax_build_model(NET)
    ref = np.asarray(bundle.module._analytic_strain.__func__(
        bundle.module, jnp.asarray(video), jnp.asarray(masks)))
    net = build_model(NET).module
    out = net._analytic_strain(torch.from_numpy(video),
                               torch.from_numpy(masks)).numpy()
    assert out.shape == ref.shape == (2, S, NET["n_strain_matrix_frames"])
    assert _range_err(out, ref) < 1e-5


def test_analytic_strain_is_zero_at_init_and_differentiable():
    """The port of ``tests/test_schemes.py::test_joint_analytic_strain_path``:
    the momentum head starts at zero (flax's initialiser), so the
    displacement and the strain are zero; the path is differentiable end to
    end with finite gradients."""
    src, tar = _volumes()
    net = build_model({**NET, "n_strain_matrix_frames": 12}).module
    init_weights(net, torch.Generator().manual_seed(0))
    out = net(torch.from_numpy(src), torch.from_numpy(tar))
    assert out["strain_matrix"].shape == (2, 1, S, 12)
    assert torch.isfinite(out["strain_matrix"]).all()
    assert out["strain_matrix"].abs().max().item() < 1e-5
    (out["strain_matrix"] ** 2).sum().backward()
    grads = [p.grad for p in net.parameters()]
    assert grads and all(g is not None and torch.isfinite(g).all()
                         for g in grads)
