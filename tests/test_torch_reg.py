"""The ``reg`` scheme of the port against the JAX package, on the CPU.

* ``RegistrationNet`` forward against flax's on weights carried by
  ``params_from_flax`` (the momentum head given small random weights, as
  flax zero-initialises it), JAX's shooting through the fused Pallas step
  and its final warp through the banded Pallas warp, both in interpret
  mode (JAX's CPU default is the unclamped gather);
* one ``reg`` train step (loss values and every parameter's gradient)
  against JAX's, with ``tests/test_torch_train.py``'s tolerances;
* ``make_registration_pairs``, ``add_displacement_fields`` and
  ``BasicRegistrationDataset`` against JAX's on one seed, exactly;
* ``main.run`` on ``configs/reg.json`` end to end on the CPU: shapes, the
  injected LDDMM loss, a finite ``reconstruction_mse``, checkpoints.

Frames are 32^2 with ``reg_half_res`` (the UNet at 16^2), 4 features, 2
levels, 3 Euler steps, the final warp at radius 4 (the interpret build
grows with the radius: 12 takes 25 s). About 22 s on the CPU.
"""

import copy
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cardiax.ops.shooting as jax_shooting
import cardiax.ops.warp_pallas as wp
from cardiax.data.datasets import \
    BasicRegistrationDataset as JaxBasicRegistrationDataset
from cardiax.data.loader import Batcher as JaxBatcher
from cardiax.data.synthetic import \
    add_displacement_fields as jax_add_displacement_fields
from cardiax.data.synthetic import make_dataset as jax_make_dataset
from cardiax.data.synthetic import \
    make_registration_pairs as jax_make_registration_pairs
from cardiax.models import build_model as jax_build_model
from cardiax.parallel.mesh import get_mesh
from cardiax.train import build_trainer as jax_build_trainer
from cardiax_torch import main as port_main
from cardiax_torch.data.datasets import BasicRegistrationDataset
from cardiax_torch.data.loader import Batcher
from cardiax_torch.data.synthetic import (add_displacement_fields,
                                          make_dataset,
                                          make_registration_pairs, save_npy)
from cardiax_torch.io.convert import params_from_flax
from cardiax_torch.models import build_model
from cardiax_torch.train import build_trainer
from torch_budget import time_limit  # noqa: F401

H = W = 32
T = 4
CONFIG = Path(__file__).resolve().parents[1] / "configs" / "reg.json"
NET = {"type": "RegistrationNet", "features": 4, "n_levels": 2,
       "n_integration_steps": 3, "alpha": 2.0, "gamma": 1.0, "sigma": 0.03,
       "final_warp_radius": 4}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _pairs(seed=3, n_subjects=2):
    data = make_dataset(n_subjects=n_subjects, slices_per_subject=1, h=H,
                        w=W, n_frames=T, seed=seed)
    return make_registration_pairs(add_displacement_fields(data, seed=seed))


def _config():
    return {"networks": {"registration": dict(NET)},
            "training": {"scheme": "reg", "seed": 2434, "batch_size": 4,
                         "optimizers": {"registration": {
                             "type": "Adam", "learning_rate": 1e-4,
                             "weight_decay": 1e-4}}},
            "losses": {}}


@pytest.fixture(scope="module")
def reg_pair():
    """(port batch, JAX forward outputs, loss values and gradients, carried
    state dict) on the same weights and batch."""
    cfg = _config()
    batch = next(iter(Batcher(BasicRegistrationDataset(_pairs()), 4)))
    arrays = {k: jnp.asarray(v) for k, v in batch.items()
              if isinstance(v, np.ndarray)}
    mesh = get_mesh((1,), ("data",), devices=jax.devices()[:1])
    trainer = jax_build_trainer(cfg["training"], None, cfg, mesh=mesh)
    nets = {n: jax_build_model(mc) for n, mc in cfg["networks"].items()}
    trainer.setup(nets, batch, steps_per_epoch=1, seed=2434)
    params = _np_tree(trainer.params)
    head = params["registration"]["params"]["MomentumUNet_0"]["Conv_0"]
    rng = np.random.default_rng(4)
    for k in ("kernel", "bias"):
        head[k] = (rng.normal(size=head[k].shape) * 0.1).astype(np.float32)

    def loss(p):
        preds, targets = trainer.scheme.forward(trainer.modules, p, arrays,
                                                True)
        total, values = trainer.loss_calc(preds, targets)
        return total, (values, preds)

    with pytest.MonkeyPatch.context() as mp:
        # the fused interpret scan (the port's in-scan clamp) and the
        # banded final warp in interpret mode
        mp.setattr(jax_shooting, "_FORCE_FUSED", True)
        mp.setattr(jax_shooting, "bilinear_warp_banded_multi",
                   functools.partial(wp.bilinear_warp_banded_multi,
                                     interpret=True))
        (_, (values, out)), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(params)
    return {"batch": batch, "cfg": cfg,
            "out": jax.tree_util.tree_map(np.asarray, out),
            "values": jax.tree_util.tree_map(np.asarray, values),
            "grads": params_from_flax(_np_tree(grads)),
            "state": params_from_flax(params)}


def _engine(reg_pair):
    cfg = copy.deepcopy(reg_pair["cfg"])
    eng = build_trainer(cfg["training"], "cpu", cfg)
    eng.setup({n: build_model(mc) for n, mc in cfg["networks"].items()},
              None, 1, state_dicts=reg_pair["state"])
    return eng


def _rel_max(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-6)


def _rel_l2(out, ref):
    ref = np.asarray(ref, np.float64)
    return np.linalg.norm(np.asarray(out, np.float64) - ref) \
        / max(np.linalg.norm(ref), 1e-30)


def test_registration_net_forward_matches_jax(reg_pair):
    eng = _engine(reg_pair)
    net = eng.modules["registration"]
    arrays = eng.to_device(reg_pair["batch"])
    with torch.no_grad():
        out = net(arrays["source_img"], arrays["target_img"])
    ref = reg_pair["out"]
    u = np.abs(ref["displacement"]).max()
    assert 0.5 < u < 3.0          # real motion, inside the 3 px clamp
    # bf16-level, relative to each output's largest magnitude, as the
    # flagship's eval parity (measured on the CPU: 0.9-1.3e-2)
    tol = {"momentum": 5e-2, "velocity": 5e-2, "displacement": 5e-2,
           "deformed_source": 5e-2}
    assert set(out) == set(ref) - {"displacement_field_X",
                                   "displacement_field_Y"}
    for k, t in tol.items():
        assert out[k].shape == ref[k].shape, k
        err = _rel_max(out[k].numpy(), ref[k])
        assert err < t, (k, err)


def test_reg_train_step_matches_jax(reg_pair):
    eng = _engine(reg_pair)
    values_j, grads_j = reg_pair["values"], reg_pair["grads"]
    values = eng.backward(eng.to_device(reg_pair["batch"]))
    assert set(eng.loss_calc.confs) == {"registration_reconstruction"}
    # loss values: 2e-2 relative, as tests/test_torch_train.py (measured
    # 1.7e-3)
    for k in ("registration_reconstruction", "total_loss"):
        assert abs(float(values[k]) - float(values_j[k])) \
            < 2e-2 * abs(float(values_j[k])), k
    module = eng.modules["registration"]
    # a conv bias feeding a GroupNorm of one channel per group has an exact
    # zero gradient; both sides hold bf16 noise there, held against the
    # model's gradient norm instead
    zero = {f"{prefix}.conv.bias" for prefix, sub in module.named_modules()
            if hasattr(sub, "conv") and hasattr(sub, "norm")
            and sub.norm.num_groups == sub.norm.weight.numel()}
    norm = np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2)
                       for g in grads_j["registration"].values()))
    errs = {}
    for key, p in module.named_parameters():
        ref = np.asarray(grads_j["registration"][key], np.float64)
        if key in zero:
            assert np.linalg.norm(p.grad.numpy()) < 0.1 * norm, key
            assert np.linalg.norm(ref) < 0.1 * norm, key
        else:
            errs[key] = _rel_l2(p.grad.numpy(), ref)
    assert len(errs) + len(zero) == len(grads_j["registration"])
    # relative L2 per tensor < 0.1, median < 3e-2, as test_torch_train.py
    # (measured: worst 8.1e-2, a GroupNorm scale; median 2.6e-2)
    worst = max(errs, key=errs.get)
    assert errs[worst] < 0.1, (worst, errs[worst])
    assert np.median(list(errs.values())) < 3e-2


def test_registration_data_matches_jax():
    data = make_dataset(n_subjects=2, slices_per_subject=2, h=16, w=16,
                        n_frames=5, seed=6)
    ref_data = jax_make_dataset(n_subjects=2, slices_per_subject=2, h=16,
                                w=16, n_frames=5, seed=6)
    pairs = make_registration_pairs(add_displacement_fields(data, seed=6))
    ref = jax_make_registration_pairs(jax_add_displacement_fields(ref_data,
                                                                  seed=6))
    assert len(pairs) == len(ref) > 0
    for a, b in zip(pairs, ref):
        assert a.keys() == b.keys()
        for k in b:
            if isinstance(b[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k], k
    for feed in (False, True):
        cfg = {"feed_masks": feed}
        port = BasicRegistrationDataset(pairs, cfg, {}, "train")
        jds = JaxBasicRegistrationDataset(ref, cfg, {}, "train")
        got = list(Batcher(port, 3))
        want = list(JaxBatcher(jds, 3))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                if isinstance(w[k], np.ndarray):
                    np.testing.assert_array_equal(g[k], w[k])
                    assert g[k].dtype == w[k].dtype, k
                else:
                    assert g[k] == w[k], k


def test_reg_main_run_end_to_end_on_cpu(tmp_path):
    cfg = json.loads(CONFIG.read_text())
    npy = tmp_path / "pairs.npy"
    save_npy(str(npy), _pairs(seed=5, n_subjects=3))      # 9 pairs
    cfg["data"]["npy_filename"] = str(npy)
    cfg["data_split"] = {"method": "by_count", "splits": {
        "train": {"count": 5}, "val": {"count": 2}, "test": {}}}
    cfg["networks"]["registration"].update(features=4, n_levels=2,
                                           n_integration_steps=2)
    cfg["training"].update(epochs=2, batch_size=3)
    cfg["saving"]["saving_dir"] = str(tmp_path / "out")
    res = port_main.run(cfg, device="cpu")
    out = tmp_path / "out"
    assert "registration_reconstruction" in cfg["losses"]     # injected
    assert cfg["losses"]["registration_reconstruction"]["sigma"] == 0.03
    for name in ("val_pred.npy", "test_pred.npy", "model-registration.pt",
                 "checkpoints/epoch_000001.pt"):
        assert (out / name).is_file(), name
    preds = np.load(out / "test_pred.npy", allow_pickle=True)
    assert len(preds) == 2
    p = preds[0]
    assert p["deformed_source_pred"].shape == (1, H, W)
    assert p["displacement_pred"].shape == (2, H, W)
    assert p["momentum_pred"].shape == (2, H, W)
    assert p["displacement_field_X_pred"].shape == (1, H, W)
    np.testing.assert_array_equal(p["displacement_field_X_pred"][0],
                                  p["displacement_pred"][1])
    for t in ("val", "test"):
        assert np.isfinite(res[f"{t}_performance"]
                           [f"final-{t}/reconstruction_mse"])
    hist = res["train_loss_dict"]["train/total_loss"]
    assert len(hist) == 2 and np.isfinite(hist).all()
    # the bundle carries the network's sigma, as JAX's
    assert res["models"]["registration_model"].sigma == 0.03
