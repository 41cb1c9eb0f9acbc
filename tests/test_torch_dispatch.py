"""The engine's dispatch modes in the port, against the JAX engine, on the CPU.

* ``DeviceBatcher`` against ``Batcher`` batch by batch (shuffle on and
  off), ``epoch_plan()`` against ``__iter__`` and JAX's ``epoch_plan``, the
  epoch handover and a resume mid-stream (after
  ``tests/test_device_cache.py``, without the mesh case);
* ``PrefetchBatcher``: the wrapped loader's batches as tensors, the epoch
  pin forwarded, a worker's error raised in the consumer;
* the engagement attributes (``last_fuse_engaged``,
  ``last_fuse_trainval``, ``last_pipeline_engaged``) equal to JAX's
  ``TrainerEngine``'s on the same configs: ``auto``; checkpoints on (no
  pipeline); ``profile_dir`` set (no fusing); ``epoch_fuse: true`` without
  the cache (warns); a typo (``ValueError``);
* on the CPU the fused path runs the same step eagerly over the resident
  data: fused equal to the step loop, pipelined equal to unpipelined (with
  an early stop and with ``valid_period`` 2), ``eval_pipeline`` on equal to
  off, and a fused resume equal to the uninterrupted run, all
  ``torch.equal``;
* the port's ``auto`` run against JAX's ``auto`` run on the same numpy data
  and the same initial weights, within the tolerance
  ``tests/test_epoch_fuse.py::_assert_same`` holds JAX's own fused run to
  against its loop (1e-4 at epoch 0, 5e-3 after), and the
  ``host_profile_rows`` keys of the two (the port's eight dotted keys
  aside);
* ``summarize_trace`` on a synthetic ``torch.profiler`` Chrome trace, a
  host-only trace and a missing directory (after
  ``tests/test_profiling.py``), and ``others.profile_dir`` writing a trace
  of the step loop;
* ``_safe_orth`` with ``cholesky_ex`` ``torch.equal`` to ``cholesky``.

Small shapes throughout: 16^2 frames, T=6, 8 features, 2 Euler steps.
"""

import contextlib
import copy
import gzip
import json

import jax
import numpy as np
import pytest
import torch

from cardiax.data.datasets import build_datasets as jax_build_datasets
from cardiax.data.loader import Batcher as JaxBatcher
from cardiax.data.loader import DeviceBatcher as JaxDeviceBatcher
from cardiax.models import build_model as jax_build_model
from cardiax.parallel.mesh import get_mesh
from cardiax.train import build_trainer as jax_build_trainer
from cardiax_torch.data.datasets import build_datasets
from cardiax_torch.data.loader import Batcher, DeviceBatcher
from cardiax_torch.data.prefetch import PrefetchBatcher
from cardiax_torch.data.synthetic import add_displacement_fields, make_dataset
from cardiax_torch.io.convert import params_from_flax
from cardiax_torch.io.profiling import (ROW_COUNTERS, ROW_SPANS,
                                        format_summary, summarize_trace)
from cardiax_torch.models import build_model
from cardiax_torch.ops import svd_smooth
from cardiax_torch.train import build_trainer
from torch_budget import time_limit  # noqa: F401

H = W = 16
T = 6
TS = 12


# --------------------------------------------------------------------------- #
# DeviceBatcher and PrefetchBatcher                                             #
# --------------------------------------------------------------------------- #

class _ToyDataset:
    def __init__(self, n=13, h=8):
        rng = np.random.default_rng(3)
        self.items = [{"x": rng.normal(size=(h, h)).astype(np.float32),
                       "y": rng.normal(size=(4,)).astype(np.float32),
                       "slice_full_id": f"s{i}"} for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return dict(self.items[i])


def _assert_batch_equal(db, hb):
    assert torch.equal(db["x"], torch.from_numpy(hb["x"]))
    assert torch.equal(db["y"], torch.from_numpy(hb["y"]))
    assert torch.equal(db["sample_mask"], torch.from_numpy(hb["sample_mask"]))
    assert db["slice_full_id"] == hb["slice_full_id"]


@pytest.mark.parametrize("shuffle", [False, True])
def test_device_batcher_matches_batcher(shuffle):
    ds = _ToyDataset(n=13)
    host = Batcher(ds, 5, shuffle=shuffle, seed=11)
    dev = DeviceBatcher(ds, 5, shuffle=shuffle, seed=11, device="cpu")
    assert dev.device_resident and len(dev) == 3
    assert dev.nbytes() == 13 * (8 * 8 + 4) * 4
    for _ in range(3):    # the streams stay aligned across epochs
        hbs, dbs = list(host), list(dev)
        assert len(hbs) == len(dbs) == 3
        for hb, db in zip(hbs, dbs):
            _assert_batch_equal(db, hb)


def test_epoch_plan_matches_iter_and_jax():
    ds = _ToyDataset(n=11)
    a = DeviceBatcher(ds, 3, shuffle=True, seed=5, device="cpu", epoch=2)
    b = DeviceBatcher(ds, 3, shuffle=True, seed=5, device="cpu", epoch=2)
    ref = JaxDeviceBatcher(ds, 3, shuffle=True, seed=5, epoch=2)
    idx_mat, mask_mat = a.epoch_plan()
    want_idx, want_mask = ref.epoch_plan()
    np.testing.assert_array_equal(idx_mat, want_idx)
    np.testing.assert_array_equal(mask_mat, want_mask)
    batches = list(b)
    assert idx_mat.shape == (len(batches), 3) == (4, 3)
    for i, batch in enumerate(batches):
        assert torch.equal(batch["x"], b._data["x"][torch.from_numpy(
            idx_mat[i])])
        np.testing.assert_array_equal(mask_mat[i],
                                      batch["sample_mask"].numpy())
    assert a._epoch == b._epoch == ref._epoch == 3


def test_device_batcher_epoch_handover_continues_stream():
    ds = _ToyDataset(n=10)
    host = Batcher(ds, 4, shuffle=True, seed=7)
    _ = list(host)                       # epoch 0 on the host
    ref = Batcher(ds, 4, shuffle=True, seed=7)
    _ = list(ref)
    dev = DeviceBatcher(ds, 4, shuffle=True, seed=host.seed, device="cpu",
                        epoch=host._epoch)
    for hb, db in zip(ref, dev):         # epoch 1 must match
        _assert_batch_equal(db, hb)


def test_device_batcher_resumes_mid_stream():
    ds = _ToyDataset(n=11)
    full = DeviceBatcher(ds, 4, shuffle=True, seed=5, device="cpu")
    epochs = [list(full) for _ in range(4)]
    resumed = DeviceBatcher(ds, 4, shuffle=True, seed=5, device="cpu")
    resumed.set_epoch(2)
    for want, got in zip(epochs[2] + epochs[3], list(resumed) + list(resumed)):
        assert torch.equal(got["x"], want["x"])
    assert not all(torch.equal(a["x"], b["x"])
                   for a, b in zip(epochs[0], epochs[1]))


def test_prefetch_batcher_yields_the_loader_batches():
    ds = _ToyDataset(n=7)
    pre = PrefetchBatcher(Batcher(ds, 3, shuffle=True, seed=2), "cpu",
                          depth=2)
    pre.set_epoch(4)
    ref = Batcher(ds, 3, shuffle=True, seed=2)
    ref.set_epoch(4)
    got, want = list(pre), list(ref)
    assert len(pre) == len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert isinstance(g["x"], torch.Tensor)
        _assert_batch_equal(g, w)

    class Broken:
        def __len__(self):
            return 2

        def __iter__(self):
            yield {"x": np.zeros((2,), np.float32)}
            raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(PrefetchBatcher(Broken(), "cpu"))


def test_step_loop_feeds_host_loaders_through_prefetch_on_the_card():
    """``TrainerEngine._feed``, the step loop's batches: on the card a host
    loader's come through a ``PrefetchBatcher`` over that loader; a
    resident loader's, and every loader's on the CPU, come as they are."""
    cfg = _cfg()
    eng = build_trainer(cfg["training"], "cpu", cfg)
    host = Batcher(_ToyDataset(), 3)
    resident = DeviceBatcher(_ToyDataset(), 3)
    assert eng._feed(host) is host and eng._feed(resident) is resident
    eng.device = torch.device("cuda")    # nothing launches: no card needed
    fed = eng._feed(host)
    assert isinstance(fed, PrefetchBatcher) and fed.loader is host
    assert fed.device == torch.device("cuda")
    assert eng._feed(resident) is resident


# --------------------------------------------------------------------------- #
# The flagship at 16^2 (tests/test_epoch_fuse.py's configuration)               #
# --------------------------------------------------------------------------- #

def _slice_data(n_subjects=4, seed=0):
    data = add_displacement_fields(make_dataset(
        n_subjects=n_subjects, slices_per_subject=1, h=H, w=W, n_frames=T,
        seed=seed), seed=seed)
    for i, d in enumerate(data):
        d.update(slice_full_id=f"{d['subject_id']}-{i}", slice_idx=i,
                 augmented=False)
    return data


def _cfg(epochs=3, **training):
    """``tests/test_epoch_fuse.py::_cfg`` (``reg_half_res`` off: at 16^2
    JAX builds the registration UNet without its stem, which the port says
    by this key)."""
    cfg = {
        "networks": {
            "joint_register_strainmat": {
                "type": "JointRegisterStrainMatNet",
                "strainmat_net_type": "ResNet3D",
                "n_strain_matrix_frames": TS,
                "strainmat_smoothing_method": "SVD",
                "strainmat_smoothing_SVD_rank": 5, "reg_features": 8,
                "n_integration_steps": 2, "reg_half_res": False},
            "LMA": {"type": "NetStrainMat2LMA", "num_conv_layers": 2,
                    "inner_conv_channel_num": 8, "n_frames": TS}},
        "training": {"scheme": "joint_registration_strainmat_LMA",
                     "LMA_task": "TOS_regression", "LMA_threshold": 20,
                     "seed": 2434, "batch_size": 3, "epochs": epochs,
                     "optimizers": {
                         "joint_register_strainmat": {"type": "Adam",
                                                      "learning_rate": 1e-4},
                         "LMA": {"type": "Adam", "learning_rate": 5e-4}}},
        "losses": {
            "registration_reconstruction": {
                "criterion": "registration_reconstruction",
                "prediction": "various", "target": "registration_target",
                "weight": 1.0, "sigma": 0.03,
                "regularization_weight": 0.1, "enable": True},
            "TOS_regression": {"criterion": "MSELoss", "prediction": "TOS",
                               "target": "TOS", "weight": 0.005,
                               "enable": True}},
        "saving": {}, "others": {},
    }
    cfg["training"].update(training)
    return cfg


def _ds_cfg():
    return {n: {"type": "JointDataset", "data_split": [n],
                "n_myo_frames_to_use_for_regression": T,
                "n_strainmat_frames_to_use_for_regression": TS}
            for n in ("train", "val")}


def _splits():
    data = _slice_data()
    return {"train": {"data": data}, "val": {"data": data[:2]}}


def _port_run(cfg, state=None, datasets=None):
    """(exp_dict, engine) of the port's ``train`` on the CPU."""
    cfg = copy.deepcopy(cfg)
    nets = {n: build_model(mc, n_pairs=T - 1)
            for n, mc in cfg["networks"].items()}
    if state is not None:
        for name, bundle in nets.items():
            bundle.module.load_state_dict(state[name])
            bundle.initialized = True
    eng = build_trainer(cfg["training"], "cpu", cfg)
    datasets = datasets or build_datasets(_ds_cfg(), _splits())
    exp, _ = eng.train(nets, datasets)
    return exp, eng


def _assert_equal_runs(a, b):
    (ea, ta), (eb, tb) = a, b
    assert ea["train_loss_dict"] == eb["train_loss_dict"] \
        and ea["train_loss_dict"]
    assert (ea["best_epoch"], ea["best_val_loss"]) == \
        (eb["best_epoch"], eb["best_val_loss"])
    for name, module in ta.modules.items():
        sa, sb = module.state_dict(), tb.modules[name].state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa), name


def _jax_engagement(cfg, datasets):
    mesh = get_mesh((1,), ("data",), devices=jax.devices()[:1])
    nets = {n: jax_build_model(mc) for n, mc in cfg["networks"].items()}
    trainer = jax_build_trainer(cfg["training"], None, cfg, mesh=mesh)
    trainer.train(models=nets, datasets=datasets,
                  trainer_config=cfg["training"], full_config=cfg)
    return (trainer.last_fuse_engaged, trainer.last_fuse_trainval,
            trainer.last_pipeline_engaged)


def _lma_cfg(**training):
    """A config the JAX engine builds in seconds: the LMA scheme, one
    ``NetStrainMat2LMA``, over the same slices."""
    cfg = {
        "networks": {"LMA": {"type": "NetStrainMat2LMA",
                             "LMA_task": "TOS_regression",
                             "num_conv_layers": 2,
                             "inner_conv_channel_num": 4, "n_frames": 8}},
        "training": {"scheme": "LMA", "LMA_task": "TOS_regression",
                     "seed": 2434, "batch_size": 3, "epochs": 2,
                     "optimizers": {"LMA": {"type": "Adam",
                                            "learning_rate": 1e-3}}},
        "losses": {"TOS_regression": {"criterion": "MSELoss",
                                      "prediction": "TOS", "target": "TOS",
                                      "weight": 1.0, "enable": True}},
        "saving": {}, "others": {}}
    cfg["training"].update(training)
    return cfg


def _lma_ds_cfg():
    return {n: {"type": "LMADataset", "data_split": [n],
                "n_frames_to_use_for_regression": 8}
            for n in ("train", "val")}


ENGAGEMENT = {
    "auto": ({}, {}, ((True, True), True, True)),
    "checkpoints": ({}, {"saving": "ckpt"}, ((True, True), True, False)),
    "profile_dir": ({}, {"others": "profile"}, ((False, False), False,
                                                 False)),
    "fuse_true_no_cache": ({"epoch_fuse": True, "device_data_cache": False},
                           {}, ((False, False), False, False)),
}


@pytest.mark.parametrize("case", sorted(ENGAGEMENT))
def test_engagement_matches_jax(case, tmp_path):
    training, where, want = ENGAGEMENT[case]
    runs = {}
    for side in ("jax", "port"):
        cfg = _lma_cfg(epochs=1, **training)
        if where.get("saving"):
            cfg["saving"] = {"saving_dir": str(tmp_path / side),
                             "save_checkpoint": True}
        if where.get("others"):
            cfg["others"] = {"profile_dir": str(tmp_path / f"{side}_prof"),
                             "profile_steps": 1}
        with pytest.warns(RuntimeWarning, match="device-resident") \
                if case == "fuse_true_no_cache" else contextlib.nullcontext():
            if side == "jax":
                runs[side] = _jax_engagement(
                    cfg, jax_build_datasets(_lma_ds_cfg(), _splits()))
            else:
                _, eng = _port_run(cfg, datasets=build_datasets(
                    _lma_ds_cfg(), _splits()))
                runs[side] = (eng.last_fuse_engaged, eng.last_fuse_trainval,
                              eng.last_pipeline_engaged)
    assert runs["port"] == runs["jax"] == want


@pytest.mark.parametrize("key", ["device_data_cache", "epoch_fuse",
                                 "epoch_pipeline"])
def test_typo_raises_like_jax(key):
    cfg = _lma_cfg(**{key: "ture"})
    for run in (lambda: _jax_engagement(
                    cfg, jax_build_datasets(_lma_ds_cfg(), _splits())),
                lambda: _port_run(cfg, datasets=build_datasets(
                    _lma_ds_cfg(), _splits()))):
        with pytest.raises(ValueError, match=f"training.{key}='ture'"):
            run()


def test_fused_equals_step_loop():
    fused = _port_run(_cfg(device_data_cache=True, epoch_fuse=True,
                           epoch_pipeline=False))
    loop = _port_run(_cfg(device_data_cache=False, epoch_fuse=False))
    assert fused[1].last_fuse_engaged == (True, True)
    assert fused[1].last_fuse_trainval is True
    assert loop[1].last_fuse_engaged == (False, False)
    _assert_equal_runs(fused, loop)


@pytest.mark.parametrize("variant", ["early_stop", "valid_period_2"])
def test_pipelined_equals_unpipelined(variant):
    if variant == "early_stop":
        # tolerance 0 and a large lr: the val loss regresses and the stop
        # fires with an epoch in flight
        extra = {"epochs_without_improvement_tolerance": 0, "optimizers": {
            "joint_register_strainmat": {"type": "Adam",
                                         "learning_rate": 5e-2},
            "LMA": {"type": "Adam", "learning_rate": 5e-2}}}
        epochs, others = 8, {}
    else:
        extra, epochs, others = {}, 5, {"valid_period": 2}
    runs = []
    for pipe in (True, False):
        cfg = _cfg(epochs=epochs, epoch_pipeline=pipe, **extra)
        cfg["others"] = others
        runs.append(_port_run(cfg))
    assert runs[0][1].last_pipeline_engaged is True
    assert runs[1][1].last_pipeline_engaged is False
    _assert_equal_runs(*runs)
    n_epochs = len(runs[0][0]["train_loss_dict"]["train/total_loss"])
    if variant == "early_stop":
        assert n_epochs < epochs
    else:
        assert n_epochs == epochs
        assert len(runs[0][0]["train_loss_dict"]["val/total_loss"]) == 3


def test_eval_pipeline_bit_exact():
    cfg = _cfg(epochs=1)
    datasets = build_datasets(_ds_cfg(), _splits())
    exp, eng = _port_run(cfg, datasets=datasets)
    test_ds = {"test": datasets["train"]}    # 4 items at batch 3: padded
    outs = []
    for pipe in (True, False):
        tc = dict(cfg["training"], eval_pipeline=pipe)
        outs.append(eng.test(exp, test_ds, trainer_config=tc))
    (pa, fa, _), (pb, fb, _) = outs
    assert len(pa) == len(pb) == 4
    for a, b in zip(pa, pb):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k
    assert fa == fb


def test_fused_resume_equals_uninterrupted(tmp_path):
    datasets = build_datasets(_ds_cfg(), _splits())

    def train(epochs, resume, out):
        cfg = _cfg(epochs=epochs, resume=resume)
        cfg["saving"] = {"saving_dir": str(out), "save_checkpoint": True}
        return _port_run(cfg, datasets=datasets)

    full = train(4, False, tmp_path / "full")
    train(2, False, tmp_path / "resumed")
    resumed = train(4, True, tmp_path / "resumed")
    assert full[1].last_fuse_engaged == resumed[1].last_fuse_engaged \
        == (True, True)

    def rows(out):
        rows = [json.loads(line) for line in open(out / "metrics.jsonl")]
        rows = [r for r in rows if any(k.startswith("train/") for k in r)]
        steps = [r["step"] for r in rows]
        assert len(steps) == len(set(steps)), steps
        return {r["step"]: r for r in rows}

    a, b = rows(tmp_path / "full"), rows(tmp_path / "resumed")
    assert set(a) == set(b) == {0, 1, 2, 3}
    for e in (2, 3):
        assert a[e] == b[e], e
    for name, module in full[1].modules.items():
        sa, sb = module.state_dict(), resumed[1].modules[name].state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa), name


# --------------------------------------------------------------------------- #
# The port's auto run against JAX's                                             #
# --------------------------------------------------------------------------- #

def test_auto_run_matches_jax_auto_run():
    """Both engines at ``auto`` with ``host_profile`` on, from the same
    initial weights (JAX's, drawn by its ``setup``, carried over): the
    per-epoch metrics within ``_assert_same``'s tolerance (1e-4 relative
    and absolute at epoch 0, 5e-3 after), the same engagement, the same
    ``host_profile_rows`` keys (the port's eight dotted keys aside)."""
    cfg = _lma_cfg(epochs=3, host_profile=True)
    mesh = get_mesh((1,), ("data",), devices=jax.devices()[:1])
    jax_ds = jax_build_datasets(_lma_ds_cfg(), _splits())
    nets = {n: jax_build_model(mc) for n, mc in cfg["networks"].items()}
    init = jax_build_trainer(cfg["training"], None, copy.deepcopy(cfg),
                             mesh=mesh)
    init.setup(nets, next(iter(JaxBatcher(jax_ds["train"], 3))),
               steps_per_epoch=2, seed=2434)
    weights = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                     init.params)
    nets = {n: jax_build_model(mc) for n, mc in cfg["networks"].items()}
    for name, bundle in nets.items():
        bundle.params = weights[name]
    trainer = jax_build_trainer(cfg["training"], None, copy.deepcopy(cfg),
                                mesh=mesh)
    want, _ = trainer.train(models=nets, datasets=jax_ds)
    got, eng = _port_run(cfg, state=params_from_flax(weights),
                         datasets=build_datasets(_lma_ds_cfg(), _splits()))
    assert (eng.last_fuse_engaged, eng.last_fuse_trainval,
            eng.last_pipeline_engaged) == (
        trainer.last_fuse_engaged, trainer.last_fuse_trainval,
        trainer.last_pipeline_engaged) == ((True, True), True, True)
    hw, hg = want["train_loss_dict"], got["train_loss_dict"]
    assert set(hw) == set(hg) and hw
    for k in hw:
        np.testing.assert_allclose(hg[k][0], hw[k][0], rtol=1e-4, atol=1e-4,
                                   err_msg=f"{k} (epoch 0)")
        np.testing.assert_allclose(hg[k], hw[k], rtol=5e-3, atol=5e-3,
                                   err_msg=k)
    # the port's rows add dotted keys (spans and counters below JAX's
    # phases); without them they have JAX's keys, and they are the eight
    # documented ones
    assert [sorted(k for k in r if "." not in k)
            for r in eng.host_profile_rows] == \
        [sorted(r) for r in trainer.host_profile_rows]
    assert all({k for k in r if "." in k} == set(ROW_SPANS + ROW_COUNTERS)
               == {"ckpt.wait", "ckpt.to_host", "ckpt.write",
                   "ckpt.bytes_to_host", "ckpt.write_waits",
                   "dispatch.steps", "dispatch.captures", "fft.calls"}
               for r in eng.host_profile_rows)
    assert len(eng.host_profile_rows) == 3


# --------------------------------------------------------------------------- #
# Profiling                                                                     #
# --------------------------------------------------------------------------- #

def _write_trace(tmp_path, events, gz=False):
    name = "host.1.pt.trace.json" + (".gz" if gz else "")
    opener = gzip.open if gz else open
    with opener(tmp_path / name, "wt") as fh:
        json.dump({"traceEvents": events}, fh)
    return tmp_path


def test_summarize_synthetic_device_trace(tmp_path):
    events = [
        # two steps (host spans), a host op inside them
        {"ph": "X", "cat": "user_annotation", "name": "train_step",
         "pid": 1, "tid": 1, "ts": 0, "dur": 9000},
        {"ph": "X", "cat": "user_annotation", "name": "train_step",
         "pid": 1, "tid": 1, "ts": 9000, "dur": 9000},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "pid": 1,
         "tid": 1, "ts": 10, "dur": 999999},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 1, "ts": 11, "dur": 5},
        # device: a kernel twice (grouped by name), a copy, a memset
        {"ph": "X", "cat": "kernel", "name": "mc_warp_fwd_kernel",
         "pid": 0, "tid": 7, "ts": 20, "dur": 4000},
        {"ph": "X", "cat": "kernel", "name": "mc_warp_fwd_kernel",
         "pid": 0, "tid": 7, "ts": 9020, "dur": 2000},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> "
         "Device)", "pid": 0, "tid": 7, "ts": 30, "dur": 2500},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
         "pid": 0, "tid": 7, "ts": 40, "dur": 500},
        # a device-side annotation span overlaps the kernels: not counted
        {"ph": "X", "cat": "gpu_user_annotation", "name": "train_step",
         "pid": 0, "tid": 7, "ts": 20, "dur": 9000},
    ]
    s = summarize_trace(_write_trace(tmp_path, events, gz=True))
    assert s is not None
    assert s["n_steps"] == 2
    assert abs(s["total_ms"] - 9.0) < 1e-9            # 4 + 2 + 2.5 + 0.5 ms
    assert abs(s["per_step_ms"] - 4.5) < 1e-9
    ops = {r["op"]: r for r in s["ops"]}
    assert ops["mc_warp_fwd_kernel"]["count"] == 2
    assert abs(ops["mc_warp_fwd_kernel"]["ms"] - 6.0) < 1e-9
    cats = {r["category"]: r["ms"] for r in s["categories"]}
    assert cats == {"kernel": 6.0, "gpu_memcpy": 2.5, "gpu_memset": 0.5}
    text = format_summary(s)
    assert "device time 9.0 ms over 2 steps (4.5 ms/step)" in text
    assert "gpu_memcpy" in text


def test_summarize_host_only_trace_returns_none(tmp_path):
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1,
               "tid": 1, "ts": 0, "dur": 100}]
    assert summarize_trace(_write_trace(tmp_path, events)) is None


def test_missing_trace_dir_returns_none(tmp_path):
    assert summarize_trace(tmp_path / "nope") is None


def test_profile_dir_traces_the_step_loop(tmp_path, capsys):
    cfg = _cfg(epochs=2)
    cfg["others"] = {"profile_dir": str(tmp_path / "prof"),
                     "profile_steps": 2}
    _, eng = _port_run(cfg)
    assert eng.last_fuse_engaged == (False, False)
    traces = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    steps = [e for e in events if e.get("name") == "train_step"
             and e.get("cat") == "user_annotation"]
    assert len(steps) == 2             # global steps 1 and 2
    # the CPU records host events only: the summary says so
    assert "no device events" in capsys.readouterr().out


# --------------------------------------------------------------------------- #
# Capture-safe step code                                                        #
# --------------------------------------------------------------------------- #

def test_schedule_reads_a_lambdalr_checkpoint():
    """Earlier checkpoints hold ``LambdaLR``'s state; ``Schedule`` (which
    writes a tensor lr in place on the card) resumes from it."""
    from cardiax_torch.train.optim import Schedule, build_optimizer
    conf = {"type": "Adam", "learning_rate": 1e-3, "lr_scheduler": {
        "enable": True, "type": "CosineAnnealingLR", "T_max": 2,
        "eta_min": 1e-4}}
    old_opt, sched = build_optimizer([torch.nn.Parameter(torch.ones(3))],
                                     conf, steps_per_epoch=3)
    lambda_lr = torch.optim.lr_scheduler.LambdaLR(old_opt, sched.factor)
    for _ in range(4):
        old_opt.step()
        lambda_lr.step()
    opt, resumed = build_optimizer([torch.nn.Parameter(torch.ones(3))],
                                   conf, steps_per_epoch=3)
    resumed.load_state_dict(lambda_lr.state_dict())
    assert opt.param_groups[0]["lr"] == old_opt.param_groups[0]["lr"]
    for _ in range(3):
        lambda_lr.step()
        resumed.step()
        assert opt.param_groups[0]["lr"] == old_opt.param_groups[0]["lr"]


def test_safe_orth_cholesky_ex_equals_cholesky():
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.normal(size=(3, 126, 5)).astype(np.float32))
    gram = y.transpose(-1, -2) @ y
    eye = torch.eye(5)
    scale = gram.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None] / 5
    chol = torch.linalg.cholesky(gram + (1e-6 * scale + 1e-10) * eye)
    inv_l = torch.linalg.solve_triangular(chol, eye.expand_as(chol),
                                          upper=False)
    assert torch.equal(svd_smooth._safe_orth(y),
                       y @ inv_l.transpose(-1, -2))


# --------------------------------------------------------------------------- #
# Training keys the epoch's finishing reads                                     #
# --------------------------------------------------------------------------- #

# the LMA config's step loop, fused epochs, and fused epochs pipelined
PATHS = {
    "loop": {"device_data_cache": False, "epoch_fuse": False},
    "fused": {"epoch_pipeline": False},
    "pipelined": {},
}


def _lma_run(path, splits=None, **training):
    """(exp_dict, engine) of the port's LMA run on ``path``'s dispatch."""
    cfg = _lma_cfg(**PATHS[path], **training)
    exp, eng = _port_run(cfg, datasets=build_datasets(
        _lma_ds_cfg(), splits or _splits()))
    assert eng.last_fuse_engaged == ((False, False) if path == "loop"
                                     else (True, True))
    assert eng.last_pipeline_engaged is (path == "pipelined")
    return exp, eng


@pytest.mark.parametrize("path", sorted(PATHS))
def test_log_epoch_walltime_logs_every_epoch(path):
    """``training.log_epoch_walltime``: ``time/epoch_wall_s`` in every
    epoch's metrics (under pipelining the cadence), and nowhere without
    the key."""
    exp, _ = _lma_run(path, epochs=3, log_epoch_walltime=True)
    walls = exp["train_loss_dict"]["time/epoch_wall_s"]
    assert len(walls) == 3 and all(w > 0 for w in walls)
    exp, _ = _lma_run(path, epochs=3)
    assert "time/epoch_wall_s" not in exp["train_loss_dict"]


@pytest.mark.parametrize("path", ["fused", "loop"])
def test_test_as_val_validates_on_the_test_split(path):
    """``training.test_as_val``: the val metrics are those of a run whose
    val split is the test split, not those of the val split."""
    data = _slice_data()
    splits = {"train": {"data": data}, "val": {"data": data[:2]},
              "test": {"data": data[2:]}}
    ds_cfg = dict(_lma_ds_cfg(), test={"type": "LMADataset",
                                       "data_split": ["test"],
                                       "n_frames_to_use_for_regression": 8})
    runs = []
    for test_as_val, val in ((True, "val"), (False, "test"), (False, "val")):
        cfg = _lma_cfg(**PATHS[path], test_as_val=test_as_val)
        datasets = build_datasets(ds_cfg, splits)
        datasets["val"] = datasets[val]
        runs.append(_port_run(cfg, datasets=datasets)[0]["train_loss_dict"])
    as_val, on_test, on_val = runs
    assert as_val["val/total_loss"] == on_test["val/total_loss"]
    assert as_val["val/total_loss"] != on_val["val/total_loss"]


@pytest.mark.parametrize("spot, path", [(3, "loop"), (3, "fused"),
                                        (3, "pipelined"), (0, "loop"),
                                        (0, "pipelined")])
def test_metric_spot_check_raises_on_a_non_finite_loss(spot, path):
    """``training.metric_spot_check_steps``: a NaN target makes every loss
    from the first step on non-finite. The step loop raises at the first
    step the key divides (epoch 1's first step: two steps an epoch), the
    fused path at the end of epoch 0; at 0 neither raises."""
    data = copy.deepcopy(_slice_data())
    for d in data:
        d["TOS"] = np.full_like(d["TOS"], np.nan)
    splits = {"train": {"data": data}, "val": {"data": _slice_data()[:2]}}
    if not spot:
        exp, _ = _lma_run(path, splits, epochs=2, metric_spot_check_steps=0)
        assert np.isnan(exp["train_loss_dict"]["train/total_loss"]).all()
        return
    want = "epoch 1 step 3 \\(spot check\\)" if path == "loop" \
        else "epoch 0 \\(fused-epoch check\\)"
    with pytest.raises(FloatingPointError, match=want):
        _lma_run(path, splits, epochs=2, metric_spot_check_steps=spot)
