"""k-fold cross-validation, sweeps and their helpers against the JAX package.

``SplitManager`` (folds equal to JAX's), ``run_kfold`` on a tiny LMA config
(as ``tests/test_kfold.py``: JAX's metric keys, finite values, the average
of the folds), the sweep helpers and ``run_sweep`` in grid mode (JAX's
points, metric and keys), ``update_config_by_another_config`` and
``get_average_performance_dict`` (equal to JAX's), and
``HardCodedLossCalculator`` (within 1e-5 of JAX's on the same inputs). The
training runs are on the CPU with one intra-op thread.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cardiax.config.config as jconfig
import cardiax.config.sweep as jcsweep
import cardiax.data.split as jsplit
import cardiax.kfold as jkfold
import cardiax.losses.calculator as jcalc
import cardiax.losses.metrics as jmetrics
import cardiax.sweep as jsweep
import cardiax_torch.config.config as tconfig
import cardiax_torch.config.sweep as tcsweep
import cardiax_torch.data.split as tsplit
import cardiax_torch.kfold as tkfold
import cardiax_torch.losses.calculator as tcalc
import cardiax_torch.losses.metrics as tmetrics
import cardiax_torch.sweep as tsweep
from cardiax_torch.data import load_data
from cardiax_torch.data.synthetic import make_dataset, save_npy
from torch_budget import time_limit  # noqa: F401

T = 10


def _lma_config(npy, epochs=1):
    """The LMA scheme on strain matrices at 4 features (tests/test_kfold.py)."""
    return {
        "info": {"experiment_name": "kfold-test"},
        "data": {"npy_filename": str(npy),
                 "data_to_feed": [{"key": "strain_matrix"}, {"key": "TOS"}]},
        "data_split": {},
        "datasets": {n: {"type": "LMADataset", "data_split": [n],
                         "n_frames_to_use_for_regression": T}
                     for n in ("train", "val", "test")},
        "networks": {"LMA": {"type": "NetStrainMat2LMA", "num_conv_layers": 1,
                             "inner_conv_channel_num": 4, "n_frames": T}},
        "training": {"scheme": "LMA", "LMA_modality": "strain_mat", "seed": 0,
                     "batch_size": 2, "epochs": epochs,
                     "optimizers": {"LMA": {"type": "Adam",
                                            "learning_rate": 1e-3}}},
        "losses": {"TOS_regression": {"criterion": "MSELoss",
                                      "prediction": "TOS", "target": "TOS",
                                      "weight": 1.0}},
        "saving": {}, "others": {},
    }


@pytest.fixture(scope="module")
def npy(tmp_path_factory):
    p = tmp_path_factory.mktemp("kfold") / "slices.npy"
    save_npy(str(p), make_dataset(n_subjects=4, slices_per_subject=1,
                                  h=16, w=16, n_frames=T, seed=9))
    return p


FOLDS = [[".*CT00.*"], [".*CT01.*"], [".*CT02.*", ".*CT03.*"]]


def test_split_manager_folds_match_jax(npy):
    base = {"val_keep_augmented": True, "shuffle": False}
    port, ref = tsplit.SplitManager(FOLDS, base), jsplit.SplitManager(FOLDS, base)
    assert len(port) == len(ref) == 3
    assert list(port) == list(ref)
    assert port[2]["splits"]["val"]["patterns"] == FOLDS[0]
    data = load_data(_lma_config(npy)["data"])
    for fold in port:
        splits = tsplit.split_data(data, fold)
        want = jsplit.split_data(data, fold)
        for name in ("train", "val", "test"):
            assert [d["slice_full_id"] for d in splits[name]["data"]] == \
                [d["slice_full_id"] for d in want[name]["data"]]
    for bad in ([["a"]], []):
        with pytest.raises(ValueError):
            tsplit.SplitManager(bad)
    with pytest.raises(IndexError):
        port[3]


def test_run_kfold_matches_jax_keys(npy):
    cfg = _lma_config(npy)
    out = tkfold.run_kfold(cfg, FOLDS, device="cpu")
    ref = jkfold.run_kfold(cfg, FOLDS)
    assert [r["fold"] for r in out["folds"]] == [0, 1, 2]
    for got, want in zip(out["folds"], ref["folds"]):
        assert got["performance"].keys() == want["performance"].keys()
        assert all(np.isfinite(v) for v in got["performance"].values())
    assert out["average"].keys() == ref["average"].keys()
    key = "average/final-test/sector_error"
    per_fold = [v for r in out["folds"] for k, v in r["performance"].items()
                if k.endswith("final-test/sector_error")]
    assert len(per_fold) == 3
    assert np.isclose(out["average"][key], np.mean(per_fold))


def test_kfold_main_reads_the_folds_file(npy, tmp_path, monkeypatch):
    """The CLI: the config file, its overrides and the folds file reach
    ``run_kfold`` (which, called so, trains on the card: it is replaced
    here)."""
    cfg_path, folds_path = tmp_path / "cfg.json", tmp_path / "folds.json"
    cfg_path.write_text(json.dumps(_lma_config(npy)))
    folds_path.write_text(json.dumps(FOLDS[:2]))
    seen = {}

    def fake_run_kfold(config, folds, device=None):
        seen.update(config=config, folds=folds, device=device)
        return {"folds": [], "average": {}}
    monkeypatch.setattr(tkfold, "run_kfold", fake_run_kfold)
    tkfold.main(["--config-file", str(cfg_path), "--folds-file",
                 str(folds_path), "--networks--LMA--n_frames=12"])
    assert seen["folds"] == FOLDS[:2] and seen["device"] is None
    assert seen["config"]["networks"]["LMA"]["n_frames"] == 12


# --------------------------------------------------------------------------- #
# Sweeps and helpers                                                            #
# --------------------------------------------------------------------------- #

SWEEP = {"metric": {"name": "final-val/sector_error", "goal": "minimize"},
         "parameters": {
             "training--optimizers--LMA--learning_rate": {"values": [1e-3,
                                                                     1e-2]},
             "networks--LMA--inner_conv_channel_num": {"value": 4},
             "training--batch_size": 2}}


def test_sweep_helpers_match_jax(tmp_path):
    assert tsweep.expand_grid(SWEEP) == jsweep.expand_grid(SWEEP)
    assert len(tsweep.expand_grid(SWEEP)) == 2
    cfg = {"training": {"optimizers": {"LMA": {"learning_rate": 1.0}}},
           "networks": {"LMA": {}}}
    for point in tsweep.expand_grid(SWEEP) + [
            {"a--b": {"value": "3"}, "c--INDEX0": 1, "d": "true"}]:
        base = {**cfg, "c": [0, 0]}
        assert tcsweep.apply_sweep_params(base, point) == \
            jcsweep.apply_sweep_params(base, point)
    path = tmp_path / "sweep.yaml"
    path.write_text(json.dumps(SWEEP))
    assert tcsweep.load_sweep_file(str(path)) == \
        jcsweep.load_sweep_file(str(path)) == SWEEP


def test_run_sweep_grid_matches_jax(npy, tmp_path):
    cfg = _lma_config(npy)
    cfg["data_split"] = {"method": "by_count", "splits": {
        "train": {"count": 2}, "val": {"count": 1}, "test": {"count": 1}}}
    cfg["saving"] = {"saving_dir": str(tmp_path / "port"),
                     "save_prediction": False}
    out = tsweep.run_sweep(cfg, SWEEP, "grid", device="cpu")
    cfg["saving"]["saving_dir"] = str(tmp_path / "jax")
    ref = jsweep.run_sweep(cfg, SWEEP, "grid")
    assert [r["point"] for r in out] == [r["point"] for r in ref]
    assert [r["metric"] for r in out] == [r["metric"] for r in ref]
    assert all(r["score"] is not None and np.isfinite(r["score"])
               for r in out)
    assert all(r["score"] is not None for r in ref)
    with pytest.raises(RuntimeError, match="wandb"):
        tsweep.run_sweep(cfg, SWEEP, "wandb", device="cpu")


def test_update_config_by_another_config_matches_jax():
    cfg = {"a": {"b": 1, "c": {"d": [1, 2]}}, "e": 3}
    other = {"a": {"c": {"d": [3]}, "f": {"g": 4}}, "e": {"h": 5}}
    out = tconfig.update_config_by_another_config(cfg, other)
    assert out == jconfig.update_config_by_another_config(cfg, other)
    assert cfg["a"]["c"]["d"] == [1, 2]                 # the input untouched
    other["a"]["f"]["g"] = 0
    assert out["a"]["f"]["g"] == 4                      # deep-copied


def test_get_average_performance_dict_matches_jax():
    folds = [{"fold0/final-test/sector_error": 1.0, "fold0/final-val/x": 2},
             {"fold1/final-test/sector_error": 3.0, "fold1/final-val/x": 5},
             {"fold12/final-test/sector_error": 8.0, "other": 1.5}]
    out = tmetrics.get_average_performance_dict(folds)
    assert out == jmetrics.get_average_performance_dict(folds)
    assert out["average/final-test/sector_error"] == 4.0


def test_hard_coded_loss_calculator_matches_jax():
    rng = np.random.default_rng(3)
    b, p, h, w = 2, 3, 8, 8
    arr = {"deformed_source": (b, 1, p, h, w), "velocity": (b, 2, p, h, w),
           "momentum": (b, 2, p, h, w), "strainmat": (b, 1, 126, 8),
           "TOS": (b, 126)}
    outputs = {k: rng.normal(size=s).astype(np.float32)
               for k, s in arr.items()}
    targets = {"registration_target": rng.random((b, 1, p, h, w)
                                                 ).astype(np.float32),
               "strainmat": rng.normal(size=(b, 1, 126, 8)).astype(np.float32),
               "TOS": rng.normal(size=(b, 126)).astype(np.float32),
               "sample_mask": np.array([1.0, 0.0], np.float32)}
    for kw in ({}, {"sigma": 0.1, "tos_weight": 1.0}):
        total, values = tcalc.HardCodedLossCalculator(**kw)(
            {k: torch.from_numpy(v) for k, v in outputs.items()},
            {k: torch.from_numpy(v) for k, v in targets.items()})
        total_j, values_j = jcalc.HardCodedLossCalculator(**kw)(
            {k: jnp.asarray(v) for k, v in outputs.items()},
            {k: jnp.asarray(v) for k, v in targets.items()})
        assert values.keys() == values_j.keys()
        for k, v in values.items():
            ref = float(values_j[k])
            assert abs(float(v) - ref) <= 1e-5 * max(1.0, abs(ref)), k
        assert abs(float(total) - float(total_j)) <= \
            1e-5 * max(1.0, abs(float(total_j)))
