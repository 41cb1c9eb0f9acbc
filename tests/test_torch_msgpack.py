"""The port reads the JAX package's saved weights (flax msgpack).

* ``cardiax_torch.io.msgpack`` decodes what ``flax.serialization.to_bytes``
  writes, exactly as ``flax.serialization.from_bytes`` does, on a nested
  tree of f32, bf16 and int32 arrays, numpy and Python scalars, strings,
  None and empty dicts; it refuses a chunked array, ext type 2 and a
  truncated file;
* a tiny flagship trained one step by ``cardiax`` and saved by
  ``cardiax.io.export.save_trained_models`` is evaluated by the port's
  ``main.run`` with ``training.inference_only``: its test predictions
  match JAX's own evaluation within 1.9e-2 of each output's largest
  magnitude (bf16-level, as ``tests/test_torch_models.py``);
* a warm start through ``main.run`` (``load_pretrained_model``) loads
  exactly the saved tensors, and the port's ``model-{name}.pt`` of the
  inference run holds them too; so does one of a JAX
  ``NetDisplacement2LMA`` (``configs/lma.json`` on the displacement
  modality) and of a JAX ``NetDisplacement2StrainMat``
  (``configs/strainmat_pred.json``).

About 35 s on the CPU, most of it compiling the JAX model.
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from cardiax.data.loader import Batcher as JaxBatcher
from cardiax.io.export import save_trained_models as jax_save_trained_models
from cardiax.models import build_model as jax_build_model
from cardiax.parallel.mesh import get_mesh
from cardiax.train import build_trainer as jax_build_trainer
from cardiax_torch import main as port_main
from cardiax_torch.data.synthetic import make_dataset, save_npy
from cardiax_torch.io.convert import params_from_flax
from cardiax_torch.io.export import load_model_params
from cardiax_torch.io.msgpack import msgpack_restore
from torch_budget import time_limit  # noqa: F401

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "joint.json"
H = W = 32
T_MYO, T_STRAIN = 4, 8


def _tree(rng):
    return {
        "params": {
            "Dense_0": {"kernel": rng.normal(size=(5, 3)).astype(np.float32),
                        "bias": np.zeros(3, np.float32)},
            "half": jnp.asarray(rng.normal(size=(2, 4)), jnp.bfloat16),
            "ids": rng.integers(-2**31, 2**31 - 1, size=(7,), dtype=np.int32),
            "big": rng.normal(size=(40, 70)).astype(np.float32),
            "empty_array": np.zeros((0, 3), np.float32),
            "empty": {},
        },
        "step": np.int32(12), "lr": np.float32(3e-4), "count": 70000,
        "neg": -40, "ratio": 0.125, "name": "x" * 300, "none": None,
        "flag": True, "nested": {"a": {"b": {}}},
    }


def _same(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(got, torch.Tensor):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype).split(".")[-1] == want.dtype.name, path
        np.testing.assert_array_equal(got.float().numpy() if got.is_floating_point()
                                      else got.numpy(),
                                      want.astype(np.float32)
                                      if got.is_floating_point() else want,
                                      err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def test_decoder_matches_flax():
    tree = _tree(np.random.default_rng(0))
    data = serialization.to_bytes(tree)
    ref = serialization.from_bytes(tree, data)
    got = msgpack_restore(data)
    _same(got, ref)
    assert got["params"]["half"].dtype == torch.bfloat16


def test_decoder_refuses_what_it_does_not_read(monkeypatch):
    tree = {"w": np.arange(64, dtype=np.float32)}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    with pytest.raises(ValueError, match="chunked array"):
        msgpack_restore(serialization.to_bytes(tree))
    monkeypatch.undo()
    with pytest.raises(ValueError, match="ext type 2"):
        msgpack_restore(serialization.to_bytes({"z": 1 + 2j}))
    data = serialization.to_bytes(tree)
    with pytest.raises(ValueError, match="truncated"):
        msgpack_restore(data[:-3])
    with pytest.raises(ValueError, match="after the value"):
        msgpack_restore(data + msgpack.packb(1))


# --------------------------------------------------------------------------- #
# Weights trained by the JAX package                                           #
# --------------------------------------------------------------------------- #

def _config(tmp_path):
    cfg = json.loads(CONFIG.read_text())
    npy = tmp_path / "slices.npy"
    save_npy(str(npy), make_dataset(n_subjects=5, slices_per_subject=1, h=H,
                                    w=W, n_frames=T_MYO, seed=11))
    cfg["data"]["npy_filename"] = str(npy)
    cfg["data_split"] = {"method": "by_count", "splits": {
        "train": {"count": 2}, "val": {"count": 1}, "test": {}}}
    for d in cfg["datasets"].values():
        d.update(n_myo_frames_to_use_for_regression=T_MYO,
                 n_strainmat_frames_to_use_for_regression=T_STRAIN)
    cfg["networks"]["joint_register_strainmat"].update(
        reg_features=4, n_strain_matrix_frames=T_STRAIN,
        n_integration_steps=2)
    cfg["networks"]["LMA"].update(inner_conv_channel_num=4, n_frames=T_STRAIN)
    cfg["training"].update(epochs=1, batch_size=2)
    cfg["saving"] = {"saving_dir": str(tmp_path / "jax"),
                     "save_checkpoint": False, "save_prediction": True}
    cfg["others"] = {}
    return cfg


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A flagship trained one step by the JAX package and saved as msgpack,
    with JAX's own predictions on the test split."""
    from cardiax.data import load_data
    from cardiax.data.datasets import build_datasets
    from cardiax.data.split import split_data
    tmp = tmp_path_factory.mktemp("msgpack")
    cfg = _config(tmp)
    datasets = build_datasets(cfg["datasets"], split_data(
        load_data(cfg["data"], cfg), cfg["data_split"]), cfg)
    mesh = get_mesh((1,), ("data",), devices=jax.devices()[:1])
    nets = {n: jax_build_model(mc) for n, mc in cfg["networks"].items()}
    trainer = jax_build_trainer(cfg["training"], None, cfg, mesh=mesh)
    batch = next(iter(JaxBatcher(datasets["train"], 2)))
    trainer.setup(nets, batch, steps_per_epoch=1, seed=2434)
    # a random momentum head (flax zero-initialises it), so the warps move;
    # then one optimiser step of the JAX package
    params = jax.tree_util.tree_map(np.asarray, trainer.params)
    head = params["joint_register_strainmat"]["params"]["momentum_unet"]["Conv_0"]
    rng = np.random.default_rng(5)
    for k in ("kernel", "bias"):
        head[k] = (rng.normal(size=head[k].shape) * 0.02).astype(np.float32)
    arrays = {k: jnp.asarray(v) for k, v in batch.items()
              if isinstance(v, np.ndarray)}
    trainer.params, trainer.opt_states, _ = trainer._train_step(
        params, trainer.opt_states, arrays)
    for name, bundle in nets.items():
        bundle.params = trainer.params[name]
    models = {f"{n}_model": b for n, b in nets.items()}
    # JAX's CPU scan and final warp are unclamped gathers; the test holds
    # |u_inv| below 1 px, where neither of the port's clamps bites
    preds, _, _ = trainer.test(models, datasets, cfg["training"], cfg,
                               target_dataset="test")
    jax_save_trained_models(cfg["saving"]["saving_dir"], nets, cfg)
    trained = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                     {n: b.params for n, b in nets.items()})
    moved = not np.array_equal(
        trained["joint_register_strainmat"]["params"]["momentum_unet"]
        ["Conv_0"]["kernel"], head["kernel"])
    return {"cfg": cfg, "tmp": tmp, "preds": preds,
            "state": params_from_flax(trained), "moved": moved}


# bf16-level: 1.9e-2 of each output's largest magnitude, the worst error
# of the eval parity test (tests/test_torch_models.py); measured here
# 1.6-1.7e-2 (momentum, velocity, displacement), 1.0e-2 (strain_matrix),
# 7.0e-3 (TOS), 2.4e-3 (deformed_source)
_PRED_TOL = {k: 1.9e-2 for k in ("momentum", "velocity", "displacement",
                                 "deformed_source", "strain_matrix", "TOS")}


def test_port_evaluates_jax_trained_weights(jax_run):
    assert jax_run["moved"]            # one optimiser step was taken
    cfg = copy.deepcopy(jax_run["cfg"])
    jax_dir = Path(cfg["saving"]["saving_dir"])
    assert sorted(p.name for p in jax_dir.glob("model-*")) == \
        ["model-LMA.msgpack", "model-joint_register_strainmat.msgpack"]
    cfg["training"]["inference_only"] = True
    cfg["saving"].update(saving_dir=str(jax_run["tmp"] / "port"),
                         save_final_model=True)
    cfg["training"]["pretrained_model_path"] = str(jax_dir)
    cfg["training"]["load_pretrained_model"] = True
    res = port_main.run(cfg, device="cpu")
    assert "train_loss_dict" not in res      # no training ran
    preds = np.load(res["test_pred_path"], allow_pickle=True)
    ref = jax_run["preds"]
    assert len(preds) == len(ref) == 2
    u = max(np.abs(p["displacement_pred"]).max() for p in ref)
    assert 0.05 < u < 1.0      # real motion, inside every clamp
    for k, tol in _PRED_TOL.items():
        got = np.stack([p[f"{k}_pred"] for p in preds]).astype(np.float64)
        want = np.stack([p[f"{k}_pred"] for p in ref]).astype(np.float64)
        assert got.shape == want.shape, k
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
        assert err < tol, (k, err)
    # the port saved what it read, as its own state dicts
    for name, state in jax_run["state"].items():
        saved = load_model_params(Path(cfg["saving"]["saving_dir"])
                                  / f"model-{name}.pt", None)
        for k, v in state.items():
            assert torch.equal(saved[k], v), (name, k)


def test_warm_start_loads_the_saved_tensors(jax_run):
    cfg = copy.deepcopy(jax_run["cfg"])
    cfg["training"].update(load_pretrained_model=True,
                           pretrained_model_path=str(
                               cfg["saving"]["saving_dir"]))
    for opt in cfg["training"]["optimizers"].values():
        opt["learning_rate"] = 0.0       # the step leaves the weights alone
    cfg["training"]["test"] = False
    cfg["saving"].update(saving_dir=str(jax_run["tmp"] / "warm"))
    res = port_main.run(cfg, device="cpu")
    assert len(res["train_loss_dict"]["train/total_loss"]) == 1
    for name, state in jax_run["state"].items():
        got = res["models"][f"{name}_model"].module.state_dict()
        assert got.keys() == state.keys()
        for k, v in state.items():
            assert torch.equal(got[k], v), (name, k)


def test_load_model_params_checks_the_template(jax_run):
    path = Path(jax_run["cfg"]["saving"]["saving_dir"]) / "model-LMA.msgpack"
    state = jax_run["state"]["LMA"]
    assert load_model_params(path, state).keys() == state.keys()
    bad = dict(state)
    bad["fc.weight"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="fc.weight"):
        load_model_params(path, bad)


# --------------------------------------------------------------------------- #
# Warm starts of the displacement networks                                     #
# --------------------------------------------------------------------------- #

def _displacement_config(kind, tmp_path):
    """``configs/lma.json`` with a ``NetDisplacement2LMA`` on the
    displacement modality, or ``configs/strainmat_pred.json``, over 16^2
    slices with displacement fields, for one epoch at learning rate 0."""
    from cardiax_torch.data.synthetic import add_displacement_fields
    name = "lma" if kind == "NetDisplacement2LMA" else "strainmat_pred"
    cfg = json.loads((CONFIG.parent / f"{name}.json").read_text())
    npy = tmp_path / "slices.npy"
    save_npy(str(npy), add_displacement_fields(make_dataset(
        n_subjects=3, slices_per_subject=1, h=16, w=16, n_frames=6,
        seed=12), seed=12))
    cfg["data"]["npy_filename"] = str(npy)
    cfg["data_split"] = {"method": "by_count", "splits": {
        "train": {"count": 2}, "val": {"count": 1}, "test": {}}}
    if kind == "NetDisplacement2LMA":
        cfg["networks"]["LMA"] = {"type": kind, "num_conv_layers": 3,
                                  "inner_conv_channel_num": 4}
        cfg["training"]["LMA_modality"] = "displacement_field"
        cfg["data"]["data_to_feed"] += [{"key": "displacement_field_X"},
                                        {"key": "displacement_field_Y"}]
    else:
        cfg["networks"]["masks_to_strain_mat"]["features"] = 4
    for opt in cfg["training"]["optimizers"].values():
        opt["learning_rate"] = 0.0       # the step leaves the weights alone
    cfg["training"].update(epochs=1, test=False, load_pretrained_model=True,
                           pretrained_model_path=str(tmp_path / "jax"))
    cfg["saving"].update(saving_dir=str(tmp_path / "port"),
                         save_checkpoint=False)
    return cfg


@pytest.mark.parametrize("kind", ["NetDisplacement2LMA",
                                  "NetDisplacement2StrainMat"])
def test_warm_start_of_a_jax_displacement_net(kind, tmp_path):
    cfg = _displacement_config(kind, tmp_path)
    (name, net), = cfg["networks"].items()
    n_frames = cfg["datasets"]["train"]["n_frames_to_use_for_regression"]
    video = jnp.zeros((1, 2, 16, 16, n_frames), jnp.float32)
    params = jax.jit(jax_build_model(net).module.init)(jax.random.PRNGKey(3),
                                                       video)
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / f"model-{name}.msgpack").write_bytes(
        serialization.to_bytes(params))
    want = params_from_flax({name: jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32), params)})[name]
    res = port_main.run(cfg, device="cpu")
    got = res["models"][f"{name}_model"].module.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
