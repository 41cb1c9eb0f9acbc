"""Checkpoints, exact resume and the periodic figures of the port's engine.

* ``CheckpointManager``: a save/restore roundtrip and the retention policy
  (after ``tests/test_checkpoint.py``), files that ``torch.load(...,
  weights_only=True)`` reads, and a restore whose keys or shapes differ
  from the model raising ``ValueError`` that names the first such key;
* resume equals uninterrupted: the flagship scheme trained 4 epochs in one
  run, and 2 epochs then 2 more with ``training.resume``, ends with the
  same parameters and optimizer state bit for bit, and the same losses in
  epochs 2-3 (after ``tests/test_checkpoint.py::
  test_resume_equals_uninterrupted``);
* the figures land at the epochs that ``wandb_visualize_interval`` gives,
  and a failing figure warns once while training goes on;
* the writer thread, its overlap forced by holding ``torch.save`` at a
  gate: the file holds the state as it was at ``save`` though the caller
  changes it in place while the write is held; one write in flight, in
  order, with the retention and the texts of the last save; a writer's
  error raised by the next ``save``, ``wait`` or ``close`` with no file
  under the failed epoch's name; an exception inside ``train`` while a
  write is held leaves that epoch's file whole.

Everything runs on the CPU at 16^2 with 4 features: about 12 s.
"""

import copy
import json
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from cardiax_torch.data.datasets import JointDataset
from cardiax_torch.data.synthetic import make_dataset
from cardiax_torch.io import checkpoints, profiling
from cardiax_torch.io.checkpoints import CheckpointManager
from cardiax_torch.io.metrics import MetricsTracker
from cardiax_torch.models import build_model
from cardiax_torch.train import build_trainer
from torch_budget import time_limit  # noqa: F401

T_MYO = 4


def _state(scale=1.0):
    return {"params": {"LMA": {"w": torch.arange(6.0).reshape(2, 3) * scale,
                               "b": torch.ones(3)}},
            "opt_states": {"LMA": {"mu": torch.zeros(2, 3),
                                   "count": torch.tensor(7)}}}


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", max_to_keep=2)
    assert mgr.latest_epoch() is None
    s0, s1 = _state(1.0), _state(2.0)
    assert mgr.save(0, s0["params"], s0["opt_states"],
                    extra={"epoch": 0, "best_val": 1.5}, force=True)
    assert mgr.save(1, s1["params"], s1["opt_states"],
                    extra={"epoch": 1, "best_val": 0.5}, force=True)
    mgr.wait()
    assert mgr.latest_epoch() == 1
    state = mgr.restore(template={**_state(), "extra": {}})
    assert torch.equal(state["params"]["LMA"]["w"],
                       torch.arange(6.0).reshape(2, 3) * 2)
    assert state["extra"] == {"epoch": 1, "best_val": 0.5}
    assert torch.equal(mgr.restore(0)["params"]["LMA"]["w"],
                       s0["params"]["LMA"]["w"])
    # the file holds tensors, numbers, strings, lists and dicts only
    raw = torch.load(tmp_path / "ck" / "epoch_000001.pt", weights_only=True)
    assert raw["opt_states"]["LMA"]["count"].item() == 7
    mgr.close()


def test_retention_policy_and_interval(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", max_to_keep=2,
                            save_interval_epochs=2)
    saved = [mgr.save(e, {"m": torch.ones(2)}, {}, extra={"epoch": e})
             for e in range(7)]
    assert saved == [True, False, True, False, True, False, True]
    assert mgr.latest_epoch() == 6
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == \
        ["epoch_000004.pt", "epoch_000006.pt"]
    mgr.save(7, {"m": torch.ones(2)}, {}, force=True)
    assert mgr.epochs() == [6, 7]


@pytest.mark.parametrize("change, key", [
    (lambda p: p["LMA"].update(w=torch.zeros(3, 2)), "params/LMA/w"),
    (lambda p: p["LMA"].pop("b"), "params/LMA/b"),
    (lambda p: p["LMA"].update(extra_leaf=torch.zeros(1)),
     "params/LMA/extra_leaf"),
], ids=["shape", "missing_key", "extra_key"])
def test_restore_mismatch_raises_naming_the_key(tmp_path, change, key):
    mgr = CheckpointManager(tmp_path / "ck")
    saved = _state()
    change(saved["params"])
    mgr.save(0, saved["params"], saved["opt_states"], force=True)
    with pytest.raises(ValueError, match=key):
        mgr.restore(template=_state())


# --------------------------------------------------------------------------- #
# The engine: resume and figures                                               #
# --------------------------------------------------------------------------- #

def _config(saving_dir, epochs, resume=False, vis=0.5):
    opt = {"type": "Adam", "weight_decay": 1e-4, "learning_rate": 1e-3,
           "lr_scheduler": {"enable": True, "type": "CosineAnnealingLR",
                            "T_max": 1, "eta_min": 1e-5}}
    return {
        "networks": {
            "joint_register_strainmat": {
                "type": "JointRegisterStrainMatNet",
                "n_strain_matrix_frames": 8, "n_integration_steps": 2,
                "reg_features": 4, "reg_half_res": False},
            "LMA": {"type": "NetStrainMat2LMA", "num_conv_layers": 2,
                    "inner_conv_channel_num": 4, "n_frames": 8},
        },
        "training": {"scheme": "joint_registration_strainmat_LMA",
                     "batch_size": 2, "seed": 7, "epochs": epochs,
                     "resume": resume,
                     "optimizers": {"joint_register_strainmat": dict(opt),
                                    "LMA": dict(opt)}},
        "losses": {
            "registration_reconstruction": {
                "criterion": "registration_reconstruction",
                "prediction": "various", "target": "registration_target",
                "weight": 1.0, "sigma": 0.03, "regularization_weight": 0.1},
            "registration_supervision": {
                "criterion": "MSELoss", "prediction": "strainmat",
                "target": "strainmat", "weight": 1000.0},
            "TOS_regression": {"criterion": "MSELoss", "prediction": "TOS",
                               "target": "TOS", "weight": 0.005}},
        "saving": {"saving_dir": str(saving_dir), "save_checkpoint": True,
                   "save_model_num": 2},
        "others": {"wandb_visualize_interval": vis},
    }


def _datasets():
    cfg = {"n_myo_frames_to_use_for_regression": T_MYO,
           "n_strainmat_frames_to_use_for_regression": 8}
    data = make_dataset(n_subjects=5, slices_per_subject=1, h=16, w=16,
                        n_frames=T_MYO, seed=8)
    return {"train": JointDataset(data[:3], dataset_config=cfg),
            "val": JointDataset(data[3:], dataset_config=cfg)}


def _train(cfg):
    """(exp_dict, engine) of one ``train`` call on fresh networks."""
    cfg = copy.deepcopy(cfg)
    eng = build_trainer(cfg["training"], "cpu", cfg)
    nets = {n: build_model(mc, n_pairs=T_MYO - 1)
            for n, mc in cfg["networks"].items()}
    exp, _ = eng.train(nets, _datasets(), cfg["training"], cfg,
                       tracker=MetricsTracker(quiet=True))
    return exp, eng


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Uninterrupted 4 epochs; 2 epochs then a resumed 4."""
    root = tmp_path_factory.mktemp("resume")
    whole, _ = _train(_config(root / "whole", 4))
    first, _ = _train(_config(root / "split", 2))
    resumed, eng = _train(_config(root / "split", 4, resume=True))
    return root, whole, first, resumed, eng


def test_resume_equals_uninterrupted(runs):
    root, whole, first, resumed, eng = runs
    hist_w, hist_r = whole["train_loss_dict"], resumed["train_loss_dict"]
    assert len(first["train_loss_dict"]["train/total_loss"]) == 2
    assert set(hist_r) == set(hist_w)
    for key, values in hist_w.items():
        assert len(values) == 4 and hist_r[key] == values[2:], key
    # training moves the loss, so equal histories are not trivially equal
    assert hist_w["train/total_loss"][3] != hist_w["train/total_loss"][2]
    assert (resumed["best_epoch"], resumed["best_val_loss"]) == \
        (whole["best_epoch"], whole["best_val_loss"])
    # the final (best) parameters
    for name, bundle in whole.items():
        if not name.endswith("_model"):
            continue
        other = resumed[name].module.state_dict()
        for k, v in bundle.module.state_dict().items():
            assert torch.equal(v, other[k]), (name, k)
    # the last epoch's whole state: parameters, optimizers, schedules
    ck_w = CheckpointManager(root / "whole" / "checkpoints").restore(3)
    ck_r = CheckpointManager(root / "split" / "checkpoints").restore(3)

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k in sorted(tree, key=str):
                yield from leaves(tree[k], f"{path}/{k}")
        else:
            yield path, tree
    got = dict(leaves({k: ck_r[k] for k in ("params", "opt_states",
                                             "best_params")}))
    want = dict(leaves({k: ck_w[k] for k in ("params", "opt_states",
                                              "best_params")}))
    assert got.keys() == want.keys() and len(got) > 50
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, got[k]), k
        else:
            assert v == got[k], k
    assert {k: v for k, v in ck_r["extra"].items() if k != "rng_cpu"} == \
        {k: v for k, v in ck_w["extra"].items() if k != "rng_cpu"}
    assert (root / "split" / "checkpoints" / "best_metrics.json").read_text() \
        == (root / "whole" / "checkpoints" / "best_metrics.json").read_text()
    # retention: save_model_num = 2
    assert CheckpointManager(root / "split" / "checkpoints").epochs() == [2, 3]


def test_resume_into_another_model_raises(runs, tmp_path):
    root = runs[0]
    cfg = _config(root / "split", 5, resume=True)
    cfg["networks"]["LMA"]["inner_conv_channel_num"] = 6
    with pytest.raises(ValueError, match="params/LMA/"):
        _train(cfg)


def test_figures_at_the_interval(runs):
    root = runs[0]
    # interval 0.5 of 4 epochs: every 2 epochs
    assert sorted(p.name for p in (root / "whole" / "figures").iterdir()) \
        == ["epoch_0000.png", "epoch_0002.png"]
    png = (root / "whole" / "figures" / "epoch_0002.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"


def test_failing_figure_warns_once(tmp_path, monkeypatch):
    from cardiax_torch.train.engine import Scheme

    def broken(self, batch, preds_np, out_path):
        raise RuntimeError("no display")
    monkeypatch.setattr(Scheme, "visualize", broken)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        exp, _ = _train(_config(tmp_path, 2, vis=0.5))
    msgs = [str(w.message) for w in caught
            if "periodic visualization failed" in str(w.message)]
    assert len(msgs) == 1 and "RuntimeError: no display" in msgs[0]
    assert len(exp["train_loss_dict"]["train/total_loss"]) == 2
    assert np.isfinite(exp["train_loss_dict"]["train/total_loss"]).all()
    assert json.loads((tmp_path / "checkpoints" / "best_metrics.json")
                      .read_text())


# --------------------------------------------------------------------------- #
# The writer thread                                                            #
# --------------------------------------------------------------------------- #

class Gate:
    """``torch.save`` as the checkpoint writer calls it: each call records
    its file's name; the writes of the epochs in ``held`` wait for
    ``release`` (then ``after`` seconds more), and ``fail``'s raises."""

    def __init__(self, monkeypatch, held=(), fail=None, after=0.0):
        self.held, self.fail, self.after = set(held), fail, after
        self.names = []
        self.entered, self.release = threading.Event(), threading.Event()
        self.save = torch.save
        monkeypatch.setattr(checkpoints.torch, "save", self)

    def __call__(self, obj, path):
        self.names.append(path.name)
        epoch = int(path.name[len("epoch_"):].split(".")[0])
        if epoch == self.fail:
            raise OSError("disk full")
        if epoch in self.held:
            self.entered.set()
            assert self.release.wait(5)
            time.sleep(self.after)
        self.save(obj, path)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree, key=str) for t in _tensors(tree[k])]
    return []


def _files(directory):
    return sorted(p.name for p in directory.glob("epoch_*.pt"))


def test_the_file_holds_the_state_as_it_was_at_save(tmp_path, monkeypatch):
    gate = Gate(monkeypatch, held={0})
    mgr = CheckpointManager(tmp_path / "ck")
    state = {**_state(), "best_params": _state(3.0)["params"]}
    before = copy.deepcopy(state)
    assert mgr.save(0, state["params"], state["opt_states"],
                    best_params=state["best_params"], force=True)
    assert gate.entered.wait(5) and _files(tmp_path / "ck") == []
    for t in _tensors(state):
        t.add_(1)      # the next epoch's steps, in place
    gate.release.set()
    saved = mgr.restore(0)
    got, want = _tensors({k: saved[k] for k in before}), _tensors(before)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    mgr.close()


def test_one_write_in_flight_in_order(tmp_path, monkeypatch):
    gate = Gate(monkeypatch, held={0})
    mgr = CheckpointManager(tmp_path / "ck", max_to_keep=2)

    def save(epoch):
        profiling.set_epoch(epoch)
        assert mgr.save(epoch, {"m": torch.full((2,), float(epoch))}, {},
                        extra={"epoch": epoch},
                        texts={"best_metrics.json": json.dumps(epoch)})

    with profiling.recording(True) as rec:
        save(0)
        assert gate.entered.wait(5)
        second = threading.Thread(target=save, args=(1,))
        second.start()
        second.join(0.2)
        assert second.is_alive()       # the second save waits for write 0
        assert gate.names == ["epoch_000000.pt.tmp"]
        gate.release.set()
        second.join(5)
        assert not second.is_alive()
        save(2)
        assert mgr.epochs() == [1, 2]
    assert gate.names == [f"epoch_00000{e}.pt.tmp" for e in range(3)]
    assert json.loads((tmp_path / "ck" / "best_metrics.json").read_text()) \
        == 2
    assert mgr.restore()["extra"] == {"epoch": 2}
    assert rec.counts[(1, "ckpt.write_waits")] == 1
    assert (0, "ckpt.write_waits") not in rec.counts
    assert [s.epoch for s in rec.named("ckpt.write")] == [0, 1, 2]


@pytest.mark.parametrize("call", ["save", "wait", "close"])
def test_a_write_error_is_raised_by_the_next_call(tmp_path, monkeypatch, call):
    Gate(monkeypatch, fail=1)
    mgr = CheckpointManager(tmp_path / "ck")
    for epoch in (0, 1):    # save 1 hands its state over and returns
        assert mgr.save(epoch, {"m": torch.ones(2)}, {}, force=True)
    with pytest.raises(OSError, match="disk full"):
        if call == "save":
            mgr.save(2, {"m": torch.ones(2)}, {}, force=True)
        else:
            getattr(mgr, call)()
    assert _files(tmp_path / "ck") == ["epoch_000000.pt"]
    mgr.wait()              # raised once
    assert mgr.epochs() == [0]


def test_an_exception_in_train_leaves_the_held_file_whole(tmp_path,
                                                         monkeypatch):
    gate = Gate(monkeypatch, held={1}, after=0.05)
    ck = tmp_path / "checkpoints"

    class Failing(MetricsTracker):
        def log(self, metrics, step=None):
            if step == 2:
                # epoch 1's write is held: let it go and raise at once
                assert gate.entered.is_set()
                assert _files(ck) == ["epoch_000000.pt"]
                gate.release.set()
                raise RuntimeError("stop")
            super().log(metrics, step)

    cfg = _config(tmp_path, 3, vis=0)
    eng = build_trainer(cfg["training"], "cpu", cfg)
    nets = {n: build_model(mc, n_pairs=T_MYO - 1)
            for n, mc in cfg["networks"].items()}
    with pytest.raises(RuntimeError, match="stop"):
        eng.train(nets, _datasets(), cfg["training"], cfg,
                  tracker=Failing(quiet=True))
    assert _files(ck) == ["epoch_000000.pt", "epoch_000001.pt"]
    state = CheckpointManager(ck).restore(
        template={"params": eng._snapshot()})
    assert state["extra"]["epoch"] == 1
    assert json.loads((ck / "best_metrics.json").read_text())
