"""Parity of the port's models and eval step with the JAX package, on CPU.

Weights come from flax ``init`` and are carried into the port by
``cardiax_torch.io.convert.params_from_flax``; the momentum head, which
flax zero-initialises, gets small random weights so that the shooting and
the warps do real work. Inputs are made with numpy from a seed and fed to
both. The trunks run in bfloat16 in both frameworks, which round at other
places, so each output is held at a bf16-level tolerance stated beside it
(relative to the output's largest magnitude).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cardiax.ops.shooting as jax_shooting
from cardiax.data.datasets import JointDataset as JaxJointDataset
from cardiax.data.loader import Batcher as JaxBatcher
from cardiax.data.synthetic import make_dataset as jax_make_dataset
from cardiax.models import build_model as jax_build_model
from cardiax.models.lma_net import NetStrainMat2LMA as FlaxLMA
from cardiax.models.strain_net import ResNet3DStrainHead as FlaxStrainHead
from cardiax.models.unet import MomentumUNet as FlaxUNet
from cardiax.parallel.mesh import get_mesh
from cardiax.train import build_trainer as jax_build_trainer
from cardiax_torch.data.datasets import JointDataset
from cardiax_torch.data.loader import Batcher
from cardiax_torch.data.synthetic import make_dataset
from cardiax_torch.io.convert import (lma_state_dict, params_from_flax,
                                      strain_head_state_dict, unet_state_dict)
from cardiax_torch.models import build_model
from cardiax_torch.models.lma_net import NetStrainMat2LMA
from cardiax_torch.models.strain_net import ResNet3DStrainHead
from cardiax_torch.models.unet import MomentumUNet
from cardiax_torch.train import build_trainer
from torch_budget import time_limit  # noqa: F401

H = W = 32
T_MYO, T_STRAIN = 4, 40


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _rel_err(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-6)


def _random_head(params, rng, std):
    head = params["momentum_unet"]["Conv_0"] if "momentum_unet" in params \
        else params["Conv_0"]
    head["kernel"] = (rng.normal(size=head["kernel"].shape) * std
                      ).astype(np.float32)
    head["bias"] = (rng.normal(size=head["bias"].shape) * std
                    ).astype(np.float32)


# --------------------------------------------------------------------------- #
# Each model against flax                                                       #
# --------------------------------------------------------------------------- #

def test_momentum_unet_matches_flax():
    rng = np.random.default_rng(0)
    x = (rng.uniform(size=(3, H, W, 2)) > 0.5).astype(np.float32)
    mod = FlaxUNet(features=8, n_levels=3, half_res=True)
    p = _np_tree(jax.jit(mod.init)(jax.random.PRNGKey(1), jnp.asarray(x)))
    _random_head(p["params"], rng, 0.1)
    ref = np.asarray(jax.jit(mod.apply)(p, jnp.asarray(x)))
    net = MomentumUNet(8, 3, half_res=True)
    net.load_state_dict(unet_state_dict(p["params"]))
    with torch.inference_mode():
        out = net(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (3, H, W, 2)
    assert np.abs(ref).max() > 0.1
    # bf16 trunk: one block differs by 1-2 bf16 ulps (rounding at other
    # places); 12 blocks stack it to ~2e-2 of the output's range
    assert _rel_err(out, ref) < 5e-2


def test_strain_head_matches_flax():
    rng = np.random.default_rng(1)
    video = rng.normal(size=(2, 5, 16, 16, 2)).astype(np.float32)
    mod = FlaxStrainHead(126, 8, out_frames=T_STRAIN)
    p = _np_tree(jax.jit(mod.init)(jax.random.PRNGKey(2), jnp.asarray(video)))
    ref = np.asarray(jax.jit(mod.apply)(p, jnp.asarray(video)))
    net = ResNet3DStrainHead(126, 8, in_frames=5, out_frames=T_STRAIN)
    net.load_state_dict(strain_head_state_dict(p["params"]))
    with torch.inference_mode():
        out = net(torch.from_numpy(video)).numpy()
    assert out.shape == ref.shape == (2, 126, T_STRAIN)
    assert _rel_err(out, ref) < 2e-2       # bf16 trunk, 3 residual blocks


def test_lma_net_matches_flax():
    rng = np.random.default_rng(2)
    strain = (rng.normal(size=(2, 1, 126, T_STRAIN)) * 0.1).astype(np.float32)
    mod = FlaxLMA(inner_conv_channel_num=8, n_frames=T_STRAIN)
    p = _np_tree(jax.jit(mod.init)(jax.random.PRNGKey(3), jnp.asarray(strain)))
    ref = np.asarray(jax.jit(mod.apply)(p, jnp.asarray(strain))["TOS"])
    net = NetStrainMat2LMA(inner_conv_channel_num=8, n_frames=T_STRAIN)
    net.load_state_dict(lma_state_dict(p["params"]))
    with torch.inference_mode():
        out = net(torch.from_numpy(strain))["TOS"].numpy()
    assert out.shape == ref.shape == (2, 126)
    assert _rel_err(out, ref) < 1e-2       # bf16 conv stack + bf16 dense


# --------------------------------------------------------------------------- #
# The whole eval step                                                           #
# --------------------------------------------------------------------------- #

def _config():
    losses = {
        "registration_reconstruction": {
            "criterion": "registration_reconstruction", "prediction": "various",
            "target": "registration_target", "weight": 1.0, "sigma": 0.03,
            "regularization_weight": 0.1, "enable": True},
        "registration_supervision": {
            "criterion": "MSELoss", "prediction": "strainmat",
            "target": "strainmat", "weight": 1000.0, "enable": True},
        "TOS_regression": {
            "criterion": "MSELoss", "prediction": "TOS", "target": "TOS",
            "weight": 0.005, "enable": True},
    }
    return {
        "networks": {
            "joint_register_strainmat": {
                "type": "JointRegisterStrainMatNet",
                "strainmat_net_type": "ResNet3D",
                "n_strain_matrix_frames": T_STRAIN,
                "strainmat_smoothing_method": "SVD",
                "strainmat_smoothing_SVD_rank": 5, "n_integration_steps": 5,
                "alpha": 2.0, "gamma": 1.0, "reg_features": 8},
            "LMA": {"type": "NetStrainMat2LMA", "LMA_task": "TOS_regression",
                    "num_conv_layers": 3, "inner_conv_channel_num": 8,
                    "n_frames": T_STRAIN, "n_sectors": 126},
        },
        "training": {"scheme": "joint_registration_strainmat_LMA",
                     "batch_size": 2, "LMA_threshold": 20, "seed": 2434},
        "losses": losses,
    }


def _data_cfg():
    return {"n_myo_frames_to_use_for_regression": T_MYO,
            "n_strainmat_frames_to_use_for_regression": T_STRAIN}


@pytest.fixture(scope="module")
def eval_step_pair():
    """(batches, JAX (values, preds) per batch, port engine, state dicts)."""
    cfg = _config()
    # 3 slices in batches of 2: the second batch is padded (sample_mask 0)
    data = make_dataset(n_subjects=3, slices_per_subject=1, h=H, w=W,
                        n_frames=T_MYO, seed=3)
    batches = list(Batcher(JointDataset(data, dataset_config=_data_cfg()),
                           2))
    jax_batches = list(JaxBatcher(JaxJointDataset(
        jax_make_dataset(n_subjects=3, slices_per_subject=1, h=H, w=W,
                         n_frames=T_MYO, seed=3), dataset_config=_data_cfg()), 2))
    mesh = get_mesh((1,), ("data",), devices=jax.devices()[:1])
    nets = {n: jax_build_model(mc) for n, mc in cfg["networks"].items()}
    trainer = jax_build_trainer(cfg["training"], None, cfg, mesh=mesh)
    trainer.setup(nets, jax_batches[0], steps_per_epoch=1, seed=2434)
    params = _np_tree(trainer.params)
    _random_head(params["joint_register_strainmat"]["params"],
                 np.random.default_rng(4), 0.02)
    results = []
    # the fused interpret scan carries the in-scan clamp that the port's
    # kernel has; the final warp takes JAX's unclamped CPU gather, so this
    # test keeps |u_inv| below the 11 px clamp (asserted below)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_shooting, "_FORCE_FUSED", True)
        for b in jax_batches:
            arrays = {k: jnp.asarray(v) for k, v in b.items()
                      if isinstance(v, np.ndarray)}
            values, preds = trainer._eval_step(params, arrays)
            results.append((jax.tree_util.tree_map(np.asarray, values),
                            jax.tree_util.tree_map(np.asarray, preds)))
    state = params_from_flax(params)
    eng = build_trainer(cfg["training"], "cpu", cfg)
    eng.setup({n: build_model(mc, n_pairs=T_MYO - 1)
               for n, mc in cfg["networks"].items()}, None, 1,
              state_dicts=state)
    return batches, jax_batches, results, eng, params, state


def test_port_data_matches_jax_data(eval_step_pair):
    batches, jax_batches = eval_step_pair[:2]
    assert len(batches) == 2
    np.testing.assert_array_equal(batches[1]["sample_mask"], [1.0, 0.0])
    for b, jb in zip(batches, jax_batches):
        for k in ("cine_myo_mask", "strain_matrix", "TOS", "sample_mask"):
            np.testing.assert_array_equal(b[k], jb[k])


def test_params_from_flax_carries_every_leaf(eval_step_pair):
    params, state = eval_step_pair[4], eval_step_pair[5]
    for name in params:
        n_leaves = len(jax.tree_util.tree_leaves(params[name]))
        assert len(state[name]) == n_leaves, name


# per-output bf16-level tolerances, relative to the largest magnitude
# (measured on CPU: momentum, velocity and displacement ~1.5e-2 from the
# bf16 UNet, strain_matrix ~1e-2, TOS ~2e-3, the losses <= 1e-2)
_PRED_TOL = {"momentum": 5e-2, "velocity": 5e-2, "displacement": 5e-2,
             "deformed_source": 5e-2, "strain_matrix": 5e-2, "TOS": 2e-2}
_VALUE_TOL = {"registration_reconstruction": 2e-2,
              "registration_supervision": 5e-2, "TOS_regression": 2e-2,
              "total_loss": 2e-2, "max_abs_displacement": 5e-2}


@pytest.mark.parametrize("batch_idx", [0, 1])
def test_eval_step_matches_jax(eval_step_pair, batch_idx):
    batches, _, results, eng = eval_step_pair[:4]
    values_j, preds_j = results[batch_idx]
    values, preds = eng.eval_step(eng.to_device(batches[batch_idx]))
    # the final warp's clamp (radius 12 -> 11 px) must not bite: JAX's CPU
    # path warps by the unclamped gather
    assert 0.05 < float(values["max_abs_displacement"]) < 11.0
    assert set(values) == set(values_j)
    for k, tol in _VALUE_TOL.items():
        assert _rel_err(values[k].numpy(), values_j[k]) < tol, k
    for k, tol in _PRED_TOL.items():
        assert preds[k].shape == preds_j[k].shape, k
        assert _rel_err(preds[k].numpy(), preds_j[k]) < tol, k


def test_engine_test_reports_real_samples_only(eval_step_pair):
    batches, _, results, eng = eval_step_pair[:4]
    cfg = _config()
    data = make_dataset(n_subjects=3, slices_per_subject=1, h=H, w=W,
                        n_frames=T_MYO, seed=3)
    test_set = JointDataset(data, dataset_config=_data_cfg())
    preds, perf, _ = eng.test({}, {"test": test_set}, cfg["training"])
    assert len(preds) == 3                     # the padded item is dropped
    assert preds[0]["TOS_pred"].shape == (126,)
    total_j = np.mean([float(v["total_loss"]) for v, _ in results])
    assert abs(perf["final-test/loss_total_loss"] - total_j) \
        < 2e-2 * abs(total_j)
    assert 0.0 <= perf["final-test/LMA_auc"] <= 1.0
    assert np.isfinite(perf["final-test/sector_error"])
