"""The port's training path against the JAX package, on the CPU.

* ``init_weights`` against JAX's ``init_params``, leaf by leaf (the random
  streams differ: shapes, exact zero/one leaves and the moments);
* ``train.optim`` against ``cardiax.train.engine.build_optimizer`` on a fixed
  gradient sequence that crosses the end of the cosine decay;
* one flagship train step (loss values and every parameter's gradient) and a
  3-step ``total_loss`` trajectory against JAX's, on weights carried from
  flax, with the fused interpret-mode scan (which runs the Pallas backward
  of the EPDiff step) on the JAX side;
* ``TrainerEngine.train``'s bookkeeping (history, early stopping, best
  weights restored) and its shuffle order against JAX's ``Batcher``;
* the config loader and override DSL, and ``load_data`` + ``split_data`` +
  ``build_datasets``, against ``cardiax``'s on the same inputs;
* ``main.run`` end to end on the CPU.

Tolerances are stated beside each comparison with the error measured.
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cardiax.ops.shooting as jax_shooting
from cardiax.config import config as jax_config
from cardiax.data import load_data as jax_load_data
from cardiax.data.datasets import JointDataset as JaxJointDataset
from cardiax.data.datasets import build_datasets as jax_build_datasets
from cardiax.data.loader import Batcher as JaxBatcher
from cardiax.data.split import split_data as jax_split_data
from cardiax.models import build_model as jax_build_model
from cardiax.parallel.mesh import get_mesh
from cardiax.train import build_trainer as jax_build_trainer
from cardiax.train.engine import build_optimizer as jax_build_optimizer
from cardiax_torch import main as port_main
from cardiax_torch.config import config as port_config
from cardiax_torch.data import load_data
from cardiax_torch.data.datasets import JointDataset, build_datasets
from cardiax_torch.data.loader import Batcher
from cardiax_torch.data.split import split_data
from cardiax_torch.data.synthetic import make_dataset, save_npy
from cardiax_torch.io.convert import params_from_flax
from cardiax_torch.io.metrics import MetricsTracker
from cardiax_torch.models import build_model, init_weights
from cardiax_torch.train import build_trainer
from cardiax_torch.train.optim import build_optimizer
from torch_budget import time_limit  # noqa: F401

H = W = 32
T_MYO, T_STRAIN = 4, 40
CONFIG = Path(__file__).resolve().parents[1] / "configs" / "joint.json"


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _losses():
    return {
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


def _optimizers(lr_joint=1e-4, lr_lma=5e-4):
    sched = {"enable": True, "type": "CosineAnnealingLR", "T_max": 30,
             "eta_min": 1e-5}
    return {"joint_register_strainmat": {"type": "Adam", "weight_decay": 1e-4,
                                         "learning_rate": lr_joint,
                                         "lr_scheduler": dict(sched)},
            "LMA": {"type": "Adam", "weight_decay": 1e-4,
                    "learning_rate": lr_lma, "lr_scheduler": dict(sched)}}


def _config(features=8):
    return {
        "networks": {
            "joint_register_strainmat": {
                "type": "JointRegisterStrainMatNet",
                "strainmat_net_type": "ResNet3D",
                "n_strain_matrix_frames": T_STRAIN,
                "strainmat_smoothing_method": "SVD",
                "strainmat_smoothing_SVD_rank": 5, "n_integration_steps": 5,
                "alpha": 2.0, "gamma": 1.0, "reg_features": features},
            "LMA": {"type": "NetStrainMat2LMA", "LMA_task": "TOS_regression",
                    "num_conv_layers": 3, "inner_conv_channel_num": features,
                    "n_frames": T_STRAIN, "n_sectors": 126},
        },
        "training": {"scheme": "joint_registration_strainmat_LMA",
                     "batch_size": 2, "LMA_threshold": 20, "seed": 2434,
                     "optimizers": _optimizers()},
        "losses": _losses(),
    }


def _data_cfg():
    return {"n_myo_frames_to_use_for_regression": T_MYO,
            "n_strainmat_frames_to_use_for_regression": T_STRAIN}


def _jax_trainer(cfg, batch):
    mesh = get_mesh((1,), ("data",), devices=jax.devices()[:1])
    nets = {n: jax_build_model(mc) for n, mc in cfg["networks"].items()}
    trainer = jax_build_trainer(cfg["training"], None, cfg, mesh=mesh)
    trainer.setup(nets, batch, steps_per_epoch=1, seed=2434)
    return trainer


# --------------------------------------------------------------------------- #
# Initialisation                                                                #
# --------------------------------------------------------------------------- #

_TRUNC = 2.0 / .87962566103423978    # flax's truncation, in units of std


def test_init_weights_follows_the_flax_initialisers():
    cfg = _config(features=16)        # the flagship's widths
    batch = next(iter(JaxBatcher(JaxJointDataset(
        make_dataset(n_subjects=1, slices_per_subject=2, h=H, w=W,
                     n_frames=T_MYO, seed=0), dataset_config=_data_cfg()), 2)))
    ref = params_from_flax(_np_tree(_jax_trainer(cfg, batch).params))
    nets = {n: build_model(mc, n_pairs=T_MYO - 1)
            for n, mc in cfg["networks"].items()}
    gen = torch.Generator().manual_seed(0)
    n_checked = 0
    for name, bundle in nets.items():
        state = init_weights(bundle.module, gen).state_dict()
        assert set(state) == set(ref[name]), name
        for key, r in ref[name].items():
            r, p = r.numpy().astype(np.float64), state[key].numpy()
            assert p.shape == r.shape, key
            for const in (0.0, 1.0):
                assert (p == const).all() == (r == const).all(), key
            if (r == r.flat[0]).all():
                continue
            if p.size >= 1000:
                # std within 10% (measured <= 3% on these leaves)
                assert abs(p.std() / r.std() - 1.0) < 0.1, key
                n_checked += 1
            if not key.endswith("frames.weight"):   # normal(0.02): no cut
                fan_in = p.shape[0] if key.endswith("mix_weight") \
                    else int(np.prod(p.shape[1:]))
                cut = _TRUNC / np.sqrt(fan_in) * (1 + 1e-6)
                assert np.abs(p).max() <= cut and np.abs(r).max() <= cut, key
    assert n_checked > 20
    head = nets["joint_register_strainmat"].module.momentum_unet.head
    assert not head.weight.any() and not head.bias.any()


# --------------------------------------------------------------------------- #
# Optimizers                                                                    #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("conf", [
    {"type": "Adam", "weight_decay": 1e-2, "learning_rate": 1e-2},
    {"type": "AdamW", "weight_decay": 1e-2, "learning_rate": 1e-2},
    {"type": "SGD", "weight_decay": 1e-2, "learning_rate": 1e-1,
     "momentum": 0.9},
], ids=["adam_coupled", "adamw", "sgd"])
def test_optimizer_matches_optax(conf):
    conf = dict(conf, lr_scheduler={"enable": True, "type": "CosineAnnealingLR",
                                    "T_max": 2, "eta_min": 1e-3})
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(4, 3)).astype(np.float32)
    grads = rng.normal(size=(6, 4, 3)).astype(np.float32)
    tx = jax_build_optimizer(conf, steps_per_epoch=2, total_epochs=3)
    pj = jnp.asarray(p0)
    state = tx.init(pj)
    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, sched = build_optimizer([pt], conf, steps_per_epoch=2)
    for g in grads:        # 6 steps: the decay ends after 4, then holds
        upd, state = tx.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, upd)
        pt.grad = torch.from_numpy(g.copy())
        opt.step()
        sched.step()
        np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj),
                                   atol=1e-6)
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-3)


# --------------------------------------------------------------------------- #
# One train step and a short trajectory against JAX                             #
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def step_pair():
    """(port engine, device batch, JAX loss values and grads of one step,
    JAX 3-step total_loss trajectory) on the same weights and batch."""
    cfg = _config()
    data = make_dataset(n_subjects=3, slices_per_subject=1, h=H, w=W,
                        n_frames=T_MYO, seed=3)
    batch = list(Batcher(JointDataset(data, dataset_config=_data_cfg()),
                         2))[1]
    np.testing.assert_array_equal(batch["sample_mask"], [1.0, 0.0])
    trainer = _jax_trainer(cfg, batch)
    params = _np_tree(trainer.params)
    head = params["joint_register_strainmat"]["params"]["momentum_unet"]["Conv_0"]
    hrng = np.random.default_rng(4)
    for k in ("kernel", "bias"):
        head[k] = (hrng.normal(size=head[k].shape) * 0.02).astype(np.float32)
    arrays = {k: jnp.asarray(v) for k, v in batch.items()
              if isinstance(v, np.ndarray)}

    def loss(p):
        preds, targets = trainer.scheme.forward(trainer.modules, p, arrays,
                                                True)
        total, values = trainer.loss_calc(preds, targets)
        return total, values

    with pytest.MonkeyPatch.context() as mp:
        # the fused interpret scan: the Pallas forward and backward of the
        # EPDiff step, with the in-scan clamp the port's kernels have
        mp.setattr(jax_shooting, "_FORCE_FUSED", True)
        grad_fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
        (_, values), grads = grad_fn(params)
        # the 3-step trajectory: JAX's optimizers on the same jitted grads
        p, traj = params, []
        states = {n: tx.init(p[n]) for n, tx in trainer._txs.items()}
        for i in range(3):
            (_, v), g = ((None, values), grads) if i == 0 else grad_fn(p)
            traj.append(float(v["total_loss"]))
            p = dict(p)
            for n, tx in trainer._txs.items():
                upd, states[n] = tx.update(g[n], states[n], p[n])
                p[n] = optax.apply_updates(p[n], upd)
    state = params_from_flax(params)

    def engine():
        eng = build_trainer(cfg["training"], "cpu", cfg)
        eng.setup({n: build_model(mc, n_pairs=T_MYO - 1)
                   for n, mc in cfg["networks"].items()},
                  None, 1, state_dicts=state)
        return eng
    return {"engine": engine, "batch": batch,
            "values": jax.tree_util.tree_map(np.asarray, values),
            "grads": params_from_flax(_np_tree(grads)), "trajectory": traj}


def _rel_l2(out, ref):
    ref = np.asarray(ref, np.float64)
    return np.linalg.norm(np.asarray(out, np.float64) - ref) \
        / max(np.linalg.norm(ref), 1e-30)


def test_train_step_loss_and_gradients_match_jax(step_pair):
    eng = step_pair["engine"]()
    values_j, grads_j = step_pair["values"], step_pair["grads"]
    values = eng.backward(eng.to_device(step_pair["batch"]))
    # the final warp's clamp (11 px) must not bite: JAX's CPU final warp is
    # the unclamped gather
    assert 0.05 < float(values["max_abs_displacement"]) < 11.0
    # loss values: 2e-2 relative, as the eval-step test (measured <= 3.1e-4)
    for k in ("registration_reconstruction", "registration_supervision",
              "TOS_regression", "total_loss"):
        assert abs(float(values[k]) - float(values_j[k])) \
            < 2e-2 * abs(float(values_j[k])), k
    # A conv bias that feeds a GroupNorm of one channel per group has an
    # exact gradient of zero (the norm removes it); both sides hold bf16
    # rounding noise there, so those are held against the model's gradient
    # norm instead (measured <= 5.9e-2 of it).
    zero = {f"{name}.{prefix}.conv.bias"
            for name, module in eng.modules.items()
            for prefix, sub in module.named_modules()
            if hasattr(sub, "conv") and hasattr(sub, "norm")
            and sub.norm.num_groups == sub.norm.weight.numel()}
    errs = {}
    for name, module in eng.modules.items():
        norm = np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2)
                           for g in grads_j[name].values()))
        for key, p in module.named_parameters():
            ref = np.asarray(grads_j[name][key], np.float64)
            if f"{name}.{key}" in zero:
                assert np.linalg.norm(p.grad.numpy()) < 0.1 * norm, key
                assert np.linalg.norm(ref) < 0.1 * norm, key
            else:
                errs[f"{name}.{key}"] = _rel_l2(p.grad.numpy(), ref)
    assert len(zero) == 7 and len(errs) + len(zero) == \
        sum(len(g) for g in grads_j.values())
    # every other gradient: bf16 trunks on both sides round at other
    # places; relative L2 per tensor < 0.1 (measured: worst 5.6e-2, a
    # GroupNorm scale of the strain head; median below 2e-2)
    worst = max(errs, key=errs.get)
    assert errs[worst] < 0.1, (worst, errs[worst])
    assert np.median(list(errs.values())) < 3e-2


def test_three_step_trajectory_matches_jax(step_pair):
    eng = step_pair["engine"]()
    arrays = eng.to_device(step_pair["batch"])
    traj = [float(eng.train_step(arrays)["total_loss"]) for _ in range(3)]
    # 2e-2 relative per step, as the loss values (measured <= 4.6e-4)
    np.testing.assert_allclose(traj, step_pair["trajectory"], rtol=2e-2)
    assert traj[-1] != traj[0]


# --------------------------------------------------------------------------- #
# Engine bookkeeping and the shuffle order                                      #
# --------------------------------------------------------------------------- #

def _tiny_setup(lr=1e-3, epochs=3, tolerance=50, n=5):
    cfg = _config(features=4)
    cfg["networks"]["joint_register_strainmat"]["reg_half_res"] = False
    # no epoch pipelining: _RecordingTracker reads the modules when an
    # epoch's metrics are logged, which a pipelined run does while the
    # next epoch's steps hold them
    cfg["training"].update(epochs=epochs, seed=7,
                           epochs_without_improvement_tolerance=tolerance,
                           optimizers=_optimizers(lr, lr),
                           epoch_pipeline=False)
    data = make_dataset(n_subjects=n, slices_per_subject=1, h=16, w=16,
                        n_frames=T_MYO, seed=8)
    datasets = {"train": JointDataset(data[:3], dataset_config=_data_cfg()),
                "val": JointDataset(data[3:], dataset_config=_data_cfg())}
    eng = build_trainer(cfg["training"], "cpu", cfg)
    nets = {n: build_model(mc, n_pairs=T_MYO - 1)
            for n, mc in cfg["networks"].items()}
    return eng, nets, datasets


class _RecordingTracker(MetricsTracker):
    """Keeps each epoch's weights; ``monitor`` overrides val/total_loss
    (read after logging as the ``early_stop_metric``) so the best epoch is
    known in advance."""

    def __init__(self, engine, monitor=None):
        super().__init__(quiet=True)
        self.engine, self.monitor, self.states = engine, monitor, []

    def log(self, metrics, step=None):
        if "val/total_loss" in metrics and self.monitor is not None:
            metrics["val/total_loss"] = self.monitor[step]
            self.states.append(self.engine._snapshot())
        super().log(metrics, step)


def test_train_history_and_best_weights_restored():
    eng, nets, datasets = _tiny_setup()
    eng.trainer_config["early_stop_metric"] = "val/total_loss"
    tracker = _RecordingTracker(eng, monitor=[3.0, 1.0, 2.0])
    exp, _ = eng.train(nets, datasets, tracker=tracker)
    assert len(exp["train_loss_dict"]["train/total_loss"]) == 3
    assert all(np.isfinite(exp["train_loss_dict"]["train/total_loss"]))
    assert (exp["best_epoch"], exp["best_val_loss"]) == (1, 1.0)
    for name, module in eng.modules.items():
        now = module.state_dict()
        for k, v in tracker.states[1][name].items():
            assert torch.equal(now[k], v), k
    assert any(not torch.equal(eng.modules["LMA"].state_dict()[k], v)
               for k, v in tracker.states[2]["LMA"].items())


def test_train_early_stop_at_tolerance_zero():
    # lr 0: nothing changes, so the second epoch does not improve
    eng, nets, datasets = _tiny_setup(lr=0.0, epochs=5, tolerance=0)
    exp, _ = eng.train(nets, datasets, tracker=MetricsTracker(quiet=True))
    assert len(exp["train_loss_dict"]["train/total_loss"]) == 2
    assert exp["best_epoch"] == 0


@pytest.mark.parametrize("epoch", [0, 3])
def test_shuffle_order_matches_jax_batcher(epoch):
    data = make_dataset(n_subjects=7, slices_per_subject=1, h=16, w=16,
                        n_frames=T_MYO, seed=9)
    port = Batcher(JointDataset(data, dataset_config=_data_cfg()), 3,
                   shuffle=True, seed=11)
    ref = JaxBatcher(JaxJointDataset(data, dataset_config=_data_cfg()), 3,
                     shuffle=True, seed=11)
    port.set_epoch(epoch)
    ref.set_epoch(epoch)
    got, want = list(port), list(ref)
    assert len(got) == len(want) == 3
    for b, jb in zip(got, want):
        np.testing.assert_array_equal(b["TOS"], jb["TOS"])
        np.testing.assert_array_equal(b["sample_mask"], jb["sample_mask"])
        assert b["subject_id"] == jb["subject_id"]


# --------------------------------------------------------------------------- #
# Config, data and the entry point                                              #
# --------------------------------------------------------------------------- #

def test_config_loader_and_override_dsl_match_jax():
    argv = ["--config-file", str(CONFIG), "--epochs", "3", "-b", "4",
            "--saving-dir", "/x", "-l", "0.01", "--seed", "5",
            "--training--optimizers--LMA--lr_scheduler--T_max=7",
            "--data_split--splits--train--patterns--INDEX0=SET0.*",
            "--others--note", "none", "--others--flag"]
    outs = []
    for mod in (jax_config, port_config):
        args, undefined = mod.get_args(argv)
        cfg = mod.load_config_from_json(args.config_file)
        cfg = mod.update_config_by_args(cfg, args)
        outs.append(mod.update_config_by_undefined_args(cfg, undefined))
    assert outs[0] == outs[1]
    assert outs[1]["training"]["optimizers"]["LMA"]["lr_scheduler"]["T_max"] == 7
    assert outs[1]["others"]["note"] is None and outs[1]["others"]["flag"] is True
    for s in ("1e-3", "true", "No", "12", "x"):
        assert port_config.coerce_str(s) == jax_config.coerce_str(s)


@pytest.mark.parametrize("method", ["by_pattern", "by_ratio", "by_count"])
def test_data_pipeline_matches_jax(tmp_path, method):
    npy = tmp_path / "slices.npy"
    save_npy(str(npy), make_dataset(n_subjects=4, slices_per_subject=2,
                                    h=16, w=16, n_frames=6, seed=2))
    data_cfg = {"npy_filename": str(npy), "n_read": 7,
                "data_to_feed": [{"key": "cine_lv_myo_masks"},
                                 {"key": "strain_matrix"}, {"key": "TOS"}]}
    split_cfg = {
        "by_pattern": {"method": "by_pattern", "splits": {
            "train": {"patterns": [".*"], "exclude_patterns": [".*CT03.*"]},
            "val": {"patterns": [".*CT03.*"], "keep_augmented": False}}},
        "by_ratio": {"method": "by_ratio", "shuffle": True, "seed": 3,
                     "splits": {"train": {"ratio": 0.6},
                                "val": {"ratio": "rest"}}},
        "by_count": {"method": "by_count", "splits": {
            "train": {"count": 4}, "val": {}}},
    }[method]
    ds_cfg = {name: {"type": "JointDataset", "data_split": [name],
                     **_data_cfg()} for name in ("train", "val")}
    port = build_datasets(ds_cfg, split_data(load_data(data_cfg), split_cfg))
    ref = jax_build_datasets(ds_cfg, jax_split_data(jax_load_data(data_cfg),
                                                    split_cfg))
    for name in ("train", "val"):
        assert len(port[name]) == len(ref[name]) > 0
        for i in range(len(ref[name])):
            a, b = port[name][i], ref[name][i]
            assert set(a) == set(b)
            for k in b:
                if isinstance(b[k], np.ndarray):
                    np.testing.assert_array_equal(a[k], b[k])
                else:
                    assert a[k] == b[k], k


def test_main_run_end_to_end_on_cpu(tmp_path):
    cfg = json.loads(CONFIG.read_text())
    npy = tmp_path / "slices.npy"
    save_npy(str(npy), make_dataset(n_subjects=3, slices_per_subject=2,
                                    h=16, w=16, n_frames=T_MYO + 2, seed=4))
    cfg["data"]["npy_filename"] = str(npy)
    cfg["data_split"] = {"method": "by_count", "splits": {
        "train": {"count": 3}, "val": {"count": 2}, "test": {}}}
    for d in cfg["datasets"].values():
        d["n_myo_frames_to_use_for_regression"] = T_MYO
    cfg["networks"]["joint_register_strainmat"].update(reg_half_res=False,
                                                       reg_features=4)
    cfg["networks"]["LMA"]["inner_conv_channel_num"] = 4
    cfg["training"].update(epochs=1, batch_size=2)
    cfg["saving"]["saving_dir"] = str(tmp_path / "out")
    res = port_main.run(copy.deepcopy(cfg), device="cpu")
    out = tmp_path / "out"
    # the config as written: a checkpoint and a figure each epoch
    for name in ("val_pred.npy", "test_pred.npy", "config.json",
                 "performance.json", "metrics.jsonl",
                 "model-joint_register_strainmat.pt", "model-LMA.pt",
                 "checkpoints/epoch_000000.pt",
                 "checkpoints/best_metrics.json", "figures/epoch_0000.png"):
        assert (out / name).is_file(), name
    preds = np.load(out / "test_pred.npy", allow_pickle=True)
    assert len(preds) == 1 and preds[0]["TOS_pred"].shape == (126,)
    assert np.isfinite(res["val_performance"]["final-val/loss_total_loss"])
    assert len(res["train_loss_dict"]["train/total_loss"]) == 1
    state = torch.load(out / "model-LMA.pt")
    assert set(state) == set(res["models"]["LMA_model"].module.state_dict())
