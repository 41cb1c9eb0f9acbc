"""The schemes ``LMA``, ``strainmat_pred`` and ``strainmat_LMA`` of the port
against the JAX package, on the CPU.

* each new network against flax on weights carried by
  ``params_from_flax``: ``NetDisplacement2LMA`` (three tasks x both time
  layouts), ``NetStrainMat2LMA``'s three heads and
  ``NetDisplacement2StrainMat``; bf16 trunks, so each output is held at
  1.9e-2 of its largest magnitude (the flagship's eval gate; measured
  1.5e-3 to 1.4e-2);
* ``cross_entropy_loss``, ``gradient_magnitude_loss`` (value and input
  gradient), ``classification_metrics``, ``tos_sector_error`` and
  ``Scheme.performance`` against JAX's on the same inputs at float32
  tolerance (1e-6 relative; the metrics exactly);
* ``LMADataset`` and ``StrainMatDataset`` items, slice grouping and
  batches (a shuffled epoch, the last batch padded) equal to JAX's;
* one train step of each scheme (loss values and every parameter's
  gradient) against JAX's, with the tolerances of
  ``tests/test_torch_reg.py`` (measured: losses within 2.2e-3 relative,
  gradients within 5.3e-2 relative L2, medians 2.1e-3 to 1.1e-2);
* ``main.run`` on ``configs/lma.json``, ``lma_classification.json``,
  ``strainmat_pred.json`` and ``strainmat_lma.json`` as written but for
  data, split, epochs (2) and saving_dir: finite losses, checkpoints, and
  the metric keys (and values) that JAX's scheme computes from the same
  predictions.

Frames 16^2, T = 6, 4 features in the parity tests. About 60 s on the CPU.
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cardiax.data.datasets as jds
import cardiax_torch.data.datasets as tds
from cardiax.data.loader import Batcher as JaxBatcher
from cardiax.losses.calculator import cross_entropy_loss as jax_ce
from cardiax.losses.metrics import classification_metrics as jax_cls_metrics
from cardiax.losses.metrics import tos_sector_error as jax_tos_sector_error
from cardiax.losses.registration import \
    gradient_magnitude_loss as jax_grad_mag
from cardiax.models import build_model as jax_build_model
from cardiax.models.lma_net import NetDisplacement2LMA as FlaxDispLMA
from cardiax.models.lma_net import NetStrainMat2LMA as FlaxLMA
from cardiax.models.strain_net import NetDisplacement2StrainMat as FlaxD2S
from cardiax.parallel.mesh import get_mesh
from cardiax.train import build_trainer as jax_build_trainer
from cardiax.train.engine import Scheme as JaxScheme
from cardiax_torch import main as port_main
from cardiax_torch.data.loader import Batcher
from cardiax_torch.data.synthetic import (add_displacement_fields,
                                          make_dataset, save_npy)
from cardiax_torch.io.convert import params_from_flax
from cardiax_torch.losses.calculator import cross_entropy_loss
from cardiax_torch.losses.metrics import (classification_metrics,
                                          tos_sector_error)
from cardiax_torch.losses.registration import gradient_magnitude_loss
from cardiax_torch.models import build_model, init_weights
from cardiax_torch.models.lma_net import NetDisplacement2LMA, NetStrainMat2LMA
from cardiax_torch.models.strain_net import NetDisplacement2StrainMat
from cardiax_torch.train import build_trainer
from cardiax_torch.train.engine import Scheme
from torch_budget import time_limit  # noqa: F401

H = W = 16
T = 6
T_REG = 8            # n_frames_to_use_for_regression: T edge-padded to 8
NSEC = 126
CONFIGS = Path(__file__).resolve().parents[1] / "configs"
TASKS = ("TOS_regression", "LMA_sector_classification",
         "LMA_slice_classification")
# bf16 trunks: the flagship's eval gate (tests/test_torch_msgpack.py)
BF16_TOL = 1.9e-2


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _rel_max(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-6)


def _rel_l2(out, ref):
    ref = np.asarray(ref, np.float64)
    return np.linalg.norm(np.asarray(out, np.float64) - ref) \
        / max(np.linalg.norm(ref), 1e-30)


def _slices(n_subjects=3, slices_per_subject=2, h=H, w=W, n_frames=T,
            seed=0):
    """Synthetic slices with displacement fields and the slice ids and
    indices that ``load_data`` gives."""
    data = add_displacement_fields(make_dataset(
        n_subjects=n_subjects, slices_per_subject=slices_per_subject, h=h,
        w=w, n_frames=n_frames, seed=seed), seed=seed)
    for i, d in enumerate(data):
        d.update(slice_full_id=f"{d['subject_id']}-{i}", slice_idx=i,
                 augmented=False)
    return data


def assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                assert g[k].dtype == w[k].dtype, k
            else:
                assert g[k] == w[k], k


# --------------------------------------------------------------------------- #
# Networks                                                                      #
# --------------------------------------------------------------------------- #

def _net_cases():
    cases = [("disp_lma", task, tal) for task in TASKS
             for tal in (True, False)]
    cases += [("strain_lma", task, None) for task in TASKS]
    return cases + [("disp_strain", None, None)]


@pytest.mark.parametrize("kind,task,time_last", _net_cases())
def test_net_matches_flax(kind, task, time_last):
    rng = np.random.default_rng(0)
    if kind == "disp_lma":
        shape = (2, 2, H, W, T) if time_last else (2, 2, T, H, W)
        x = rng.normal(size=shape).astype(np.float32)
        mod = FlaxDispLMA(LMA_task=task, features=4, time_axis_last=time_last)
        net = NetDisplacement2LMA(task, features=4, time_axis_last=time_last,
                                  frame_size=(H, W))
    elif kind == "strain_lma":
        x = (rng.normal(size=(2, 1, NSEC, T)) * 0.1).astype(np.float32)
        mod = FlaxLMA(LMA_task=task, inner_conv_channel_num=4, n_frames=T)
        net = NetStrainMat2LMA(task, inner_conv_channel_num=4, n_frames=T)
    else:
        x = rng.normal(size=(2, 2, H, W, T)).astype(np.float32)
        mod = FlaxD2S(features=4)
        net = NetDisplacement2StrainMat(features=4)
    # eager: at these sizes faster than compiling
    p = _np_tree(mod.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    ref = mod.apply(p, jnp.asarray(x))
    net.load_state_dict(params_from_flax({"net": p})["net"])
    with torch.inference_mode():
        out = net(torch.from_numpy(x))
    assert out.keys() == ref.keys()
    for k in ref:
        assert out[k].shape == ref[k].shape, k
        assert out[k].dtype == torch.float32, k
        assert _rel_max(out[k].numpy(), ref[k]) < BF16_TOL, k


_TRUNC = 2.0 / .87962566103423978    # flax's truncation, in units of std


@pytest.mark.parametrize("net", [
    {"type": "NetDisplacement2LMA", "LMA_task": "LMA_sector_classification"},
    {"type": "NetStrainMat2LMA", "LMA_task": "LMA_slice_classification",
     "n_frames": T},
    {"type": "NetDisplacement2StrainMat"}])
def test_init_weights_follows_flax(net):
    """``init_weights`` draws the new networks' leaves as flax does (at
    their configs' 16 features): the same leaves, zeros and ones where
    flax has them, truncated ``lecun_normal`` elsewhere (fan_in 3F for a
    ``mix_weight``), the std within 10% on leaves of >= 1000 values."""
    x = np.zeros((1, 1, NSEC, T) if net["type"] == "NetStrainMat2LMA"
                 else (1, 2, H, W, T), np.float32)
    p = jax_build_model(net).module.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x))
    ref = params_from_flax({"n": _np_tree(p)})["n"]
    state = init_weights(build_model(net, frame_size=(H, W)).module,
                         torch.Generator().manual_seed(0)).state_dict()
    assert set(state) == set(ref)
    for key, r in ref.items():
        r, q = r.numpy().astype(np.float64), state[key].numpy()
        for const in (0.0, 1.0):
            assert (q == const).all() == (r == const).all(), key
        if (r == r.flat[0]).all():
            continue
        if q.size >= 1000:
            assert abs(q.std() / r.std() - 1.0) < 0.1, key
        fan_in = q.shape[0] if key.endswith("mix_weight") \
            else int(np.prod(q.shape[1:]))
        cut = _TRUNC / np.sqrt(fan_in) * (1 + 1e-6)
        assert np.abs(q).max() <= cut and np.abs(r).max() <= cut, key


# --------------------------------------------------------------------------- #
# Losses and metrics                                                            #
# --------------------------------------------------------------------------- #

def _ce_case(name, rng):
    b = 3
    mask = np.array([1, 1, 0], np.float32)
    if name == "sector":
        return (rng.normal(size=(b, 2, NSEC)),
                rng.integers(0, 2, (b, NSEC)), mask)
    if name == "slice":          # (B, 1) labels: the rank equals the
        return rng.normal(size=(b, 2)), rng.integers(0, 2, (b, 1)), mask
    if name == "slice_flat":
        return rng.normal(size=(b, 2)), rng.integers(0, 2, (b,)), None
    one_hot = np.eye(2)[rng.integers(0, 2, (b, 5))]       # (B, 5, 2)
    return rng.normal(size=(b, 2, 5)), np.moveaxis(one_hot, -1, 1), mask


@pytest.mark.parametrize("case", ["sector", "slice", "slice_flat",
                                  "one_hot"])
def test_cross_entropy_matches_jax(case):
    """One-hot labels (the logits' rank) are reduced by argmax over axis 1
    first, as in JAX, so (B, 1) slice labels become class 0; then a
    trailing axis of 1 is squeezed."""
    logits, labels, mask = _ce_case(case, np.random.default_rng(1))
    logits = logits.astype(np.float32)
    conf = {"prediction": "p", "target": "t"}

    def inputs(arr):
        tg = {"t": arr(labels)}
        if mask is not None:
            tg["sample_mask"] = arr(mask)
        return {"p": arr(logits)}, tg
    ref = float(jax_ce(*inputs(jnp.asarray), conf))
    got = float(cross_entropy_loss(*inputs(torch.from_numpy), conf))
    assert abs(got - ref) <= 1e-6 * abs(ref)


def test_gradient_magnitude_matches_jax():
    rng = np.random.default_rng(2)
    img = rng.uniform(size=(4, 1, 12, 10)).astype(np.float32)
    mask = np.array([1, 0, 1, 1], np.float32)
    conf = {"prediction": "deformed_source", "offset": 3.0}

    def ref_loss(x):
        return jax_grad_mag({"deformed_source": x},
                            {"sample_mask": jnp.asarray(mask)}, conf)
    ref, ref_g = jax.value_and_grad(ref_loss)(jnp.asarray(img))
    x = torch.from_numpy(img).requires_grad_(True)
    got = gradient_magnitude_loss({"deformed_source": x},
                                  {"sample_mask": torch.from_numpy(mask)},
                                  conf)
    got.backward()
    assert abs(float(got) - float(ref)) <= 1e-6 * abs(float(ref))
    assert _rel_max(x.grad.numpy(), ref_g) < 1e-5
    # without a mask: the mean over images
    ref = float(jax_grad_mag({"deformed_source": jnp.asarray(img)}, {}, conf))
    got = float(gradient_magnitude_loss(
        {"deformed_source": torch.from_numpy(img)}, {}, conf))
    assert abs(got - ref) <= 1e-6 * abs(ref)


def test_metrics_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(5, 2, NSEC)).astype(np.float32)
    labels = rng.integers(0, 2, (5, NSEC))
    assert classification_metrics(logits, labels) == \
        jax_cls_metrics(logits, labels)
    none = np.zeros((2, NSEC), np.int64)       # empty denominators: 0
    assert classification_metrics(np.zeros((2, 2, NSEC)), none) == \
        jax_cls_metrics(np.zeros((2, 2, NSEC)), none)
    pred, true = rng.uniform(0, 40, (2, 3, NSEC)).astype(np.float32)
    mask = np.array([1, 1, 0], np.float32)
    for m in (mask, None):
        got = tos_sector_error(torch.from_numpy(pred), torch.from_numpy(true),
                               None if m is None else torch.from_numpy(m))
        ref = jax_tos_sector_error(jnp.asarray(pred), jnp.asarray(true),
                                   None if m is None else jnp.asarray(m))
        for g, r in zip(got, ref):
            assert abs(float(g) - float(r)) <= 1e-6 * abs(float(r))


def test_scheme_performance_matches_jax():
    """Sector logits as they are, slice logits as (2, 1): the keys and
    values of JAX's ``Scheme.performance`` on the same samples."""
    rng = np.random.default_rng(4)
    sector = [{"TOS": rng.uniform(0, 40, NSEC),
               "TOS_pred": rng.uniform(0, 40, NSEC),
               "sector_LMA_labels": rng.integers(0, 2, NSEC),
               "sector_LMA_labels_pred": rng.normal(size=(2, NSEC))}
              for _ in range(4)]
    slices = [{"slice_LMA_label": rng.integers(0, 2, 1),
               "slice_LMA_label_pred": rng.normal(size=2)}
              for _ in range(5)]
    for preds in (sector, slices):
        got = Scheme({}, {}).performance(preds, "val")
        want = JaxScheme({}, {}).performance(preds, "val")
        assert got == want and "final-val/accuracy" in got


# --------------------------------------------------------------------------- #
# Datasets                                                                      #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kind", ["LMADataset", "StrainMatDataset"])
def test_dataset_batches_match_jax(kind):
    data = _slices()
    cfg = {"n_frames_to_use_for_regression": T_REG, "LMA_threshold": 20}
    port = getattr(tds, kind)(data, None, cfg, {}, "train")
    ref = getattr(jds, kind)(data, None, cfg, {}, "train")
    for method in ("get_subject_ids", "get_slice_full_ids", "get_n_slices"):
        assert getattr(port, method)() == getattr(ref, method)(), method
    assert_batches_equal(port.get_slice(2), ref.get_slice(2))
    item = port[0]
    if kind == "LMADataset":
        assert item["strain_mat"].shape == (1, NSEC, T_REG)
        assert item["displacement_field_X"].shape == (1, H, W, T_REG)
    else:                        # no channel axis on the strain matrix
        assert item["strain_mat"].shape == (NSEC, T_REG)
        assert item["displacement_field"].shape == (2, H, W, T_REG)
    # the threshold is the dataset config's
    np.testing.assert_array_equal(item["sector_LMA_labels"],
                                  (item["TOS"] > 20).astype(np.int64))
    got, want = Batcher(port, 4, shuffle=True, seed=3), \
        JaxBatcher(ref, 4, shuffle=True, seed=3)
    got.set_epoch(1)
    want.set_epoch(1)
    batches = list(got)
    assert batches[-1]["sample_mask"].tolist() == [1, 1, 0, 0]
    assert_batches_equal(batches, list(want))


# --------------------------------------------------------------------------- #
# One train step of each scheme                                                 #
# --------------------------------------------------------------------------- #

def _adam():
    return {"type": "Adam", "learning_rate": 1e-3, "weight_decay": 1e-4}


def _lma_net(task, **kw):
    return {"type": "NetStrainMat2LMA", "LMA_task": task,
            "num_conv_layers": 3, "inner_conv_channel_num": 4,
            "n_frames": T_REG, **kw}


_CE = {"criterion": "CrossEntropyLoss", "weight": 1.0, "enable": True}
STEP_CASES = {
    "LMA_tos": ("LMA", "LMADataset", {"LMA": _lma_net("TOS_regression")},
                {"TOS_regression": {"criterion": "MSELoss",
                                    "prediction": "TOS", "target": "TOS",
                                    "weight": 1.0, "enable": True}}, {}),
    "LMA_sector": ("LMA", "LMADataset",
                   {"LMA": _lma_net("LMA_sector_classification")},
                   {"sector_CE": dict(_CE, prediction="sector_LMA_labels",
                                      target="sector_LMA_labels")}, {}),
    "LMA_slice_displacement": (
        "LMA", "LMADataset",
        {"LMA": {"type": "NetDisplacement2LMA",
                 "LMA_task": "LMA_slice_classification",
                 "inner_conv_channel_num": 4}},
        {"slice_CE": dict(_CE, prediction="slice_LMA_label",
                          target="slice_LMA_label")},
        {"LMA_modality": "displacement_field"}),
    "strainmat_pred": ("strainmat_pred", "StrainMatDataset",
                       {"masks_to_strain_mat": {
                           "type": "NetDisplacement2StrainMat",
                           "features": 4}}, {}, {}),
    "strainmat_LMA": ("strainmat_LMA", "StrainMatDataset",
                      {"strain": {"type": "NetDisplacement2StrainMat",
                                  "features": 4},
                       "LMA": _lma_net("TOS_regression")}, {}, {}),
}


def _step_config(case):
    scheme, ds_type, nets, losses, extra = STEP_CASES[case]
    training = {"scheme": scheme, "seed": 2434, "batch_size": 4,
                "LMA_task": "TOS_regression",
                "optimizers": {n: _adam() for n in nets}, **extra}
    ds_cfg = {"type": ds_type, "n_frames_to_use_for_regression": T_REG}
    return {"networks": copy.deepcopy(nets), "training": training,
            "losses": copy.deepcopy(losses), "datasets": {"train": ds_cfg}}


def _zero_grad_biases(module):
    """The conv biases that feed a GroupNorm of one channel per group: the
    norm subtracts them again, so their gradient is exactly zero, and both
    sides hold bf16 cancellation noise there (up to 11.4 in JAX and 5.0 in
    the port on ``NetDisplacement2LMA``'s ``blocks.0.conv.bias``, behind a
    near-constant masked video, measured on the CPU)."""
    return {f"{prefix}.conv.bias" for prefix, sub in module.named_modules()
            if hasattr(sub, "conv") and hasattr(sub, "norm")
            and sub.norm.num_groups == sub.norm.weight.numel()}


def assert_grads_match(modules, grads_j, worst_tol=0.1):
    """Every parameter's gradient but the exact zeros: relative L2 per
    tensor < ``worst_tol`` (0.1, as tests/test_torch_reg.py), median
    < 3e-2."""
    errs = {}
    for name, module in modules.items():
        zero = _zero_grad_biases(module)
        assert set(dict(module.named_parameters())) == set(grads_j[name])
        for key, p in module.named_parameters():
            if key not in zero:
                errs[f"{name}.{key}"] = _rel_l2(p.grad.numpy(),
                                                grads_j[name][key])
    worst = max(errs, key=errs.get)
    assert errs[worst] < worst_tol, (worst, errs[worst])
    assert np.median(list(errs.values())) < 3e-2
    return errs


def jax_step(cfg, batch, patch=None):
    """JAX's loss values, gradients (as the port's state dicts) and
    weights for one batch; ``patch(params)`` may change the weights
    first."""
    mesh = get_mesh((1,), ("data",), devices=jax.devices()[:1])
    trainer = jax_build_trainer(cfg["training"], None, cfg, mesh=mesh)
    nets = {n: jax_build_model(mc) for n, mc in cfg["networks"].items()}
    trainer.setup(nets, batch, steps_per_epoch=1, seed=2434)
    params = _np_tree(trainer.params)
    if patch is not None:
        patch(params)
    arrays = {k: jnp.asarray(v) for k, v in batch.items()
              if isinstance(v, np.ndarray)}

    def loss(p):
        preds, targets = trainer.scheme.forward(trainer.modules, p, arrays,
                                                True)
        return trainer.loss_calc(preds, targets)

    (_, values), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    return (jax.tree_util.tree_map(np.asarray, values),
            params_from_flax(_np_tree(grads)), params_from_flax(params))


def port_engine(cfg, state, **shapes):
    eng = build_trainer(cfg["training"], "cpu", cfg)
    eng.setup({n: build_model(mc, **shapes)
               for n, mc in cfg["networks"].items()}, None, 1,
              state_dicts=state)
    return eng


def assert_values_match(values, values_j, names):
    """Loss values: 2e-2 relative, as tests/test_torch_train.py (bf16
    trunks before them)."""
    assert set(values) == set(names) | {"total_loss"}
    for k in values:
        assert abs(float(values[k]) - float(values_j[k])) \
            < 2e-2 * abs(float(values_j[k])), k


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax(case):
    cfg = _step_config(case)
    ds_cfg = cfg["datasets"]["train"]
    data = _slices()[:3]
    batch = next(iter(JaxBatcher(getattr(jds, ds_cfg["type"])(
        data, None, ds_cfg, {}, "train"), 4)))          # 3 real, 1 padded
    port_batch = next(iter(Batcher(getattr(tds, ds_cfg["type"])(
        data, None, ds_cfg, {}, "train"), 4)))
    assert_batches_equal([port_batch], [batch])
    values_j, grads_j, state = jax_step(copy.deepcopy(cfg), batch)
    port_cfg = copy.deepcopy(cfg)
    eng = port_engine(port_cfg, state, frame_size=(H, W))
    values = eng.backward(eng.to_device(port_batch))
    assert_values_match(values, values_j, port_cfg["losses"])
    assert_grads_match(eng.modules, grads_j)


# --------------------------------------------------------------------------- #
# main.run on the configs as written                                            #
# --------------------------------------------------------------------------- #

def main_run_config(name, npy, out, split):
    """``configs/{name}.json`` with only its data, split, epochs (2) and
    saving_dir changed."""
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    cfg["data"]["npy_filename"] = str(npy)
    cfg["data_split"] = {"method": "by_count", "splits": split}
    cfg["training"]["epochs"] = 2
    cfg["saving"]["saving_dir"] = str(out)
    return cfg


def check_main_run(cfg, res, out, model_names):
    """Finite losses each epoch, a checkpoint each epoch, the saved
    models, and the metric keys and values that JAX's scheme computes
    from the port's test predictions, with its losses (``cfg`` is the
    config as ``main.run`` was given it, before a scheme injected any)."""
    hist = res["train_loss_dict"]
    for key in ("train/total_loss", "val/total_loss"):
        assert len(hist[key]) == 2 and np.isfinite(hist[key]).all(), key
    for name in ["checkpoints/epoch_000000.pt", "checkpoints/epoch_000001.pt",
                 "test_pred.npy"] + [f"model-{n}.pt" for n in model_names]:
        assert (out / name).is_file(), name
    mesh = get_mesh((1,), ("data",), devices=jax.devices()[:1])
    jcfg = copy.deepcopy(cfg)
    trainer = jax_build_trainer(jcfg["training"], None, jcfg, mesh=mesh)
    preds = list(np.load(out / "test_pred.npy", allow_pickle=True))
    perf = res["test_performance"]
    want = trainer.scheme.performance(preds, "test")
    loss_keys = {f"final-test/loss_{k}"
                 for k in list(trainer.loss_calc.confs) + ["total_loss"]}
    assert set(perf) == set(want) | loss_keys
    for k, v in want.items():
        assert perf[k] == pytest.approx(v, rel=1e-12), k
    assert all(np.isfinite(v) for v in perf.values())
    return perf


MAIN_CASES = {"lma": ["LMA"], "lma_classification": ["LMA"],
              "strainmat_pred": ["masks_to_strain_mat"],
              "strainmat_lma": ["strain", "LMA"]}


@pytest.mark.parametrize("name", sorted(MAIN_CASES))
def test_main_run_on_cpu(tmp_path, name):
    npy = tmp_path / "slices.npy"
    save_npy(str(npy), _slices(n_subjects=3, slices_per_subject=2, seed=5))
    cfg = main_run_config(name, npy, tmp_path / "out", {
        "train": {"count": 3}, "val": {"count": 2}, "test": {}})
    res = port_main.run(copy.deepcopy(cfg), device="cpu")
    perf = check_main_run(cfg, res, tmp_path / "out", MAIN_CASES[name])
    metric = {"lma": "sector_error", "lma_classification": "accuracy",
              "strainmat_pred": "strainmat_mse",
              "strainmat_lma": "sector_error"}[name]
    assert f"final-test/{metric}" in perf
