"""Data parallelism in the port (``cardiax_torch.parallel``) against JAX's
mesh, on the CPU.

Two gloo ranks (``tests/torch_dp_worker.py``, the port only) are spawned
once for the module; the JAX references run in this process on the
conftest's virtual CPU devices while they work, and one rank's results
(the engine without a mesh) are computed here too.

* every loss criterion is a count-normalised sum (``LossCalculator.counts``):
  the shards' values weighted by their counts add up to the batch's, an
  all-padding shard to exactly 0;
* (a) the mesh helpers against ``cardiax.parallel``: ``get_mesh``'s shapes
  and errors, ``shard_batch``'s divisible and replicated cases per rank,
  ``replicate``, ``host_shard_bounds``, ``shard_global_batch``'s error
  text, and ``DeviceBatcher``/``PrefetchBatcher`` taking a rank's rows;
* (b) ``tests/test_parallel.py``'s LMA set-up (16^2, T=10, batch 8) on 2
  port ranks against JAX's ``get_mesh((2,))`` step on carried weights,
  under that test's tolerances;
* (c) the flagship at 32^2 (the kernels' plain versions) on 2 ranks
  against 1 rank (1e-3 loss, 1e-2 relative L2 gradients) and against JAX's
  mesh-(2,) step (``tests/test_torch_train.py``'s 2e-2 and 0.1);
* (d) a padded batch whose second shard is all padding, and a batch of 5
  over 2 ranks (replicated), each equal to one rank;
* (e) the ranks' parameters ``torch.equal`` after 3 steps;
* (f) ``main.run`` with ``--mesh-shape 2`` on 2 ranks: rank 0 alone
  writes, and the predictions equal a one-rank run's;
* (g) C6: ``parallel.mesh_shape`` larger than the world raises.
"""

import copy
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cardiax.data.datasets import JointDataset as JaxJointDataset
from cardiax.data.datasets import build_datasets as jax_build_datasets
from cardiax.data.loader import Batcher as JaxBatcher
from cardiax.data.synthetic import make_dataset as jax_make_dataset
from cardiax.models import build_model as jax_build_model
from cardiax.parallel import distributed as jdist
from cardiax.parallel.mesh import get_mesh as jax_get_mesh
from cardiax.parallel.mesh import shard_batch as jax_shard_batch
from cardiax.train import build_trainer as jax_build_trainer
from cardiax_torch import main as port_main
from cardiax_torch.data.loader import Batcher, DeviceBatcher
from cardiax_torch.data.prefetch import PrefetchBatcher
from cardiax_torch.data.synthetic import make_dataset, save_npy
from cardiax_torch.io.convert import params_from_flax
from cardiax_torch.losses.calculator import LossCalculator
from cardiax_torch.models import build_model
from cardiax_torch.parallel import distributed as tdist
from cardiax_torch.parallel import get_mesh
from cardiax_torch.parallel.mesh import Mesh
from cardiax_torch.train import build_trainer
from torch_budget import time_limit  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_dp_worker.py"
CONFIG = REPO / "configs" / "joint.json"
WORLD = 2
T_LMA = 10               # tests/test_parallel.py's set-up
H = W = 32               # the flagship: tests/test_torch_train.py's
T_MYO, T_STRAIN = 4, 40


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _arrays(batch, mesh):
    return {k: v for k, v in jax_shard_batch(batch, mesh).items()
            if isinstance(v, jax.Array)}


def _rel_l2(out, ref):
    ref = np.asarray(ref, np.float64)
    return np.linalg.norm(np.asarray(out, np.float64) - ref) \
        / max(np.linalg.norm(ref), 1e-30)


# --------------------------------------------------------------------------- #
# The cases' inputs                                                             #
# --------------------------------------------------------------------------- #

def _lma_config():
    """``tests/test_parallel.py``'s LMA config."""
    return {
        "networks": {"LMA": {"type": "NetStrainMat2LMA",
                             "num_conv_layers": 1,
                             "inner_conv_channel_num": 4,
                             "n_frames": T_LMA}},
        "training": {"scheme": "LMA", "LMA_modality": "strain_mat",
                     "seed": 7, "batch_size": 8, "epochs": 1,
                     "optimizers": {"LMA": {"type": "Adam",
                                            "learning_rate": 1e-3}}},
        "losses": {"TOS_regression": {"criterion": "MSELoss",
                                      "prediction": "TOS", "target": "TOS",
                                      "weight": 1.0}},
        "saving": {}, "others": {},
    }


def _lma_dataset():
    data = jax_make_dataset(n_subjects=4, slices_per_subject=2, h=16, w=16,
                            n_frames=T_LMA, seed=13)
    for i, d in enumerate(data):
        d["slice_full_id"] = f"{d['subject_id']}-{i}"
        d["slice_idx"] = i
        d["augmented"] = False
    return jax_build_datasets(
        {"train": {"type": "LMADataset", "data_split": ["train"],
                   "n_frames_to_use_for_regression": T_LMA}},
        {"train": {"data": data}})["train"]


def _flagship_config():
    """``tests/test_torch_train.py``'s flagship at 32^2, batch 4."""
    sched = {"enable": True, "type": "CosineAnnealingLR", "T_max": 30,
             "eta_min": 1e-5}
    losses = json.loads(CONFIG.read_text())["losses"]
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
                     "batch_size": 4, "LMA_threshold": 20, "seed": 2434,
                     "optimizers": {
                         "joint_register_strainmat": {
                             "type": "Adam", "weight_decay": 1e-4,
                             "learning_rate": 1e-4,
                             "lr_scheduler": dict(sched)},
                         "LMA": {"type": "Adam", "weight_decay": 1e-4,
                                 "learning_rate": 5e-4,
                                 "lr_scheduler": dict(sched)}}},
        "losses": losses,
    }


def _flagship_batches():
    data = make_dataset(n_subjects=4, slices_per_subject=3, h=H, w=W,
                        n_frames=T_MYO, seed=3)
    ds_cfg = {"n_myo_frames_to_use_for_regression": T_MYO,
              "n_strainmat_frames_to_use_for_regression": T_STRAIN}
    batches = list(JaxBatcher(JaxJointDataset(data, dataset_config=ds_cfg),
                              4))
    padded = next(iter(JaxBatcher(JaxJointDataset(
        data[:2], dataset_config=ds_cfg), 4)))
    assert len(batches) == 3
    np.testing.assert_array_equal(padded["sample_mask"], [1, 1, 0, 0])
    return batches, padded


def _main_config(tmp: Path, out: Path):
    """configs/joint.json as ``tests/test_torch_train.py``'s end-to-end run
    cuts it (16^2, 4 features, 1 epoch, batch 2): the train split's last
    batch and the test batch hold one real slice, so rank 1's shard of them
    is all padding."""
    cfg = json.loads(CONFIG.read_text())
    npy = tmp / "slices.npy"
    if not npy.exists():
        save_npy(str(npy), make_dataset(n_subjects=3, slices_per_subject=2,
                                        h=16, w=16, n_frames=T_MYO + 2,
                                        seed=4))
    cfg["data"]["npy_filename"] = str(npy)
    cfg["data_split"] = {"method": "by_count", "splits": {
        "train": {"count": 3}, "val": {"count": 2}, "test": {}}}
    for d in cfg["datasets"].values():
        d["n_myo_frames_to_use_for_regression"] = T_MYO
    cfg["networks"]["joint_register_strainmat"].update(reg_half_res=False,
                                                       reg_features=4)
    cfg["networks"]["LMA"]["inner_conv_channel_num"] = 4
    cfg["training"].update(epochs=1, batch_size=2)
    cfg["saving"]["saving_dir"] = str(out)
    return cfg


def _port_engine(case, mesh=None):
    cfg = case["cfg"]
    eng = build_trainer(cfg["training"], "cpu", cfg, mesh=mesh)
    eng.setup({n: build_model(mc, **case.get("shapes", {}))
               for n, mc in cfg["networks"].items()}, None, 1,
              state_dicts=case["state"])
    return eng


def _grads(eng):
    return {n: {k: p.grad.detach().clone()
                for k, p in m.named_parameters() if p.grad is not None}
            for n, m in eng.modules.items()}


def _floats(values):
    return {k: float(v) for k, v in values.items()}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(work: Path):
    env = dict(os.environ, WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1")
    env.pop("CARDIAX_NUM_PROCESSES", None)
    procs = []
    for rank in range(WORLD):
        log = open(work / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(WORKER), str(work)],
            env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)),
            stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _join(procs, work: Path, timeout: float = 120.0):
    """Wait for every rank (a hung rendezvous fails here, after
    ``timeout`` s, instead of eating the suite's limit)."""
    try:
        for proc, log in procs:
            proc.wait(timeout=timeout)
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    logs = [(work / f"rank{r}.log").read_text() for r in range(WORLD)]
    for (proc, _), text in zip(procs, logs):
        assert proc.returncode == 0, text[-4000:]
    return [torch.load(work / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    work = tmp_path_factory.mktemp("dp")
    mesh2 = jax_get_mesh((WORLD,))
    # (b) tests/test_parallel.py's set-up on JAX's 2-device mesh
    lma_cfg = _lma_config()
    lma_ds = _lma_dataset()
    lma_batch = next(iter(JaxBatcher(lma_ds, 8, shuffle=False)))
    lma_batch5 = next(iter(JaxBatcher(lma_ds, 5, shuffle=False)))
    lma_trainer = jax_build_trainer(lma_cfg["training"], None, lma_cfg,
                                    mesh=mesh2)
    lma_trainer.setup({n: jax_build_model(mc)
                       for n, mc in lma_cfg["networks"].items()},
                      lma_batch, steps_per_epoch=1, seed=7)
    lma = {"cfg": lma_cfg, "state": params_from_flax(
        _np_tree(lma_trainer.params)), "batch": lma_batch,
        "batch5": lma_batch5}
    # (c) the flagship, JAX's head patched as tests/test_torch_train.py
    # does (JAX zero-initialises it: every warp would be the identity)
    fl_cfg = _flagship_config()
    batches, padded = _flagship_batches()
    fl_trainer = jax_build_trainer(fl_cfg["training"], None,
                                   copy.deepcopy(fl_cfg), mesh=mesh2)
    fl_trainer.setup({n: jax_build_model(mc)
                      for n, mc in fl_cfg["networks"].items()},
                     batches[0], steps_per_epoch=1, seed=2434)
    fl_params = _np_tree(fl_trainer.params)
    head = fl_params["joint_register_strainmat"]["params"][
        "momentum_unet"]["Conv_0"]
    hrng = np.random.default_rng(4)
    for k in ("kernel", "bias"):
        head[k] = (hrng.normal(size=head[k].shape) * 0.02).astype(np.float32)
    flagship = {"cfg": fl_cfg, "state": params_from_flax(fl_params),
                "shapes": {"n_pairs": T_MYO - 1}, "batches": batches,
                "padded": padded}
    main_cfg = _main_config(work, work / "run_dp")
    torch.save({"lma": lma, "flagship": flagship,
                "main": {"cfg": copy.deepcopy(main_cfg)}},
               work / "inputs.pt")
    procs = _spawn(work)
    try:
        # while the ranks work: JAX's mesh steps and one port rank
        jax_ref = {}
        a2 = _arrays(lma_batch, mesh2)
        _, pred = lma_trainer._eval_step(lma_trainer.params, a2)
        jax_ref["lma_tos"] = np.asarray(pred["TOS"])
        p2, _, v2 = lma_trainer._train_step(lma_trainer.params,
                                            lma_trainer.opt_states, a2)
        jax_ref["lma_total"] = float(v2["total_loss"])
        jax_ref["lma_params"] = params_from_flax(_np_tree(p2))
        fa = _arrays(batches[0], mesh2)

        def loss(p):
            preds, targets = fl_trainer.scheme.forward(fl_trainer.modules, p,
                                                       fa, True)
            return fl_trainer.loss_calc(preds, targets)
        (_, values), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, fl_params))
        jax_ref["flagship_values"] = _floats(values)
        jax_ref["flagship_grads"] = params_from_flax(_np_tree(grads))

        one = {}
        eng = _port_engine(flagship)
        one["flagship_values"] = []
        for b in batches:
            one["flagship_values"].append(_floats(eng.train_step(
                eng.to_device(b))))
            one.setdefault("flagship_grads", _grads(eng))
        pad = _port_engine(flagship)
        one["pad_values"] = _floats(pad.backward(pad.to_device(padded)))
        one["pad_grads"] = _grads(pad)
        eng = _port_engine(lma)
        arrays = eng.to_device(lma_batch)
        one["lma_tos"] = eng.eval_step(arrays)[1]["TOS"]
        one["lma_values"] = _floats(eng.train_step(arrays))
        one["lma_params"] = {n: {k: v.detach().clone()
                                 for k, v in m.state_dict().items()}
                             for n, m in eng.modules.items()}
        eng5 = _port_engine(lma)
        one["lma_values5"] = _floats(eng5.backward(eng5.to_device(
            lma_batch5)))
        one["lma_grads5"] = _grads(eng5)
        one["main"] = port_main.run(_main_config(work, work / "run_one"),
                                    device="cpu")
    except BaseException:
        for proc, log in procs:
            proc.kill()
            proc.wait()
            log.close()
        raise
    ranks = _join(procs, work)
    return {"ranks": ranks, "jax": jax_ref, "one": one, "work": work,
            "lma_batch": lma_batch}


# --------------------------------------------------------------------------- #
# The losses' counts                                                            #
# --------------------------------------------------------------------------- #

def _loss_case(criterion, rng):
    """(conf, outputs, targets) of one criterion on a batch of 6."""
    def f(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    if criterion == "MSELoss":
        return ({"prediction": "p", "target": "t"},
                {"p": f(6, 3, 4)}, {"t": f(6, 3, 4)})
    if criterion == "CrossEntropyLoss":
        return ({"prediction": "p", "target": "t"}, {"p": f(6, 3, 5)},
                {"t": torch.from_numpy(rng.integers(0, 3, (6, 5)))})
    img = {"deformed_source": f(6, 1, 8, 8)}
    if criterion == "gradient_magnitude":
        return {"offset": 1.0}, img, {}
    return ({}, dict(img, velocity=f(6, 2, 8, 8), momentum=f(6, 2, 8, 8)),
            {"registration_target": f(6, 1, 8, 8)})


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "rows"])
@pytest.mark.parametrize("criterion", ["MSELoss", "CrossEntropyLoss",
                                       "registration_reconstruction",
                                       "gradient_magnitude"])
def test_every_loss_is_a_count_normalised_sum(criterion, masked):
    """What the ranks' scaling rests on: a term's value on the batch is the
    sum over its shards of value x count, over the batch's count (its
    ``sample_mask``'s sum, or its rows); the third shard, all padding,
    gives exactly 0. 1e-6 relative (float32 sums in another order)."""
    conf, outputs, targets = _loss_case(criterion,
                                        np.random.default_rng(0))
    if masked:
        targets["sample_mask"] = torch.tensor([1., 0., 1., 1., 0., 0.])
    calc = LossCalculator({"term": dict(conf, criterion=criterion)})
    want = calc(outputs, targets)[1]["term"]
    total = calc.counts(outputs, targets, "cpu")
    parts = []
    for rows in (slice(0, 2), slice(2, 4), slice(4, 6)):
        o = {k: v[rows] for k, v in outputs.items()}
        t = {k: v[rows] for k, v in targets.items()}
        parts.append(calc(o, t)[1]["term"] * calc.counts(o, t, "cpu")[0])
    assert total.shape == (1,)
    assert float(total[0]) == (3.0 if masked else 6.0)
    if masked:
        assert float(parts[2]) == 0.0
    got = sum(parts) / total[0]
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


# --------------------------------------------------------------------------- #
# (a) the mesh helpers                                                          #
# --------------------------------------------------------------------------- #

def test_get_mesh_shapes_and_errors_match_jax():
    mesh = get_mesh()                 # one process: a world of one rank
    assert mesh.shape == {"data": 1} and mesh.axis_names == ("data",)
    assert mesh.group is None and mesh.device == (
        torch.device("cuda", 0) if torch.cuda.is_available()
        else torch.device("cpu"))
    assert get_mesh((1, 1)).axis_names == jax_get_mesh((1, 1)).axis_names \
        == ("data", "seq")
    assert get_mesh((1,), ("batch",)).shape == {"batch": 1}
    for port_args, jax_args in ((((1, 1), ("data",)), ((1, 1), ("data",))),
                                (((2,),), ((16,),))):
        with pytest.raises(ValueError) as port_err:
            get_mesh(*port_args)
        with pytest.raises(ValueError) as jax_err:
            jax_get_mesh(*jax_args)
        # JAX's wording; the port adds how to launch more ranks
        assert str(port_err.value).startswith(
            str(jax_err.value).replace("16", "2").replace("have 8",
                                                          "have 1"))
    assert "torchrun --nproc-per-node 2" in str(port_err.value)


def test_shard_global_batch_error_and_bounds_match_jax():
    batch = {"x": np.zeros((), np.float32)}
    with pytest.raises(ValueError) as port_err:
        tdist.shard_global_batch(batch, get_mesh((1,), devices=["cpu"]))
    with pytest.raises(ValueError) as jax_err:
        jdist.shard_global_batch(batch, jax_get_mesh((1,)))
    assert str(port_err.value) == str(jax_err.value)
    assert tdist.host_shard_bounds(10) == jdist.host_shard_bounds(10)
    assert tdist.initialize_distributed() is False


def test_ranks_take_jax_shards(dp):
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    y = np.arange(5, dtype=np.float32)
    ref = jax_shard_batch({"x": x, "y": y, "ids": ["a"] * 8},
                          jax_get_mesh((WORLD,)))
    shards = {s.device.id: np.asarray(s.data)
              for s in ref["x"].addressable_shards}
    for r, out in enumerate(dp["ranks"]):
        assert (out["rank"], out["world"], out["backend"]) == \
            (r, WORLD, "gloo")
        h = out["helpers"]
        np.testing.assert_array_equal(h["x"].numpy(), shards[r])
        np.testing.assert_array_equal(h["y"].numpy(), np.asarray(ref["y"]))
        assert h["ids"] == ref["ids"]
        assert torch.equal(h["replicated"], torch.zeros(3))  # rank 0's
        assert h["bounds"] == (5 * r, 5 * (r + 1))
        assert torch.equal(h["global_local"],
                           torch.from_numpy(x[:4] + 100 * r))
        assert torch.equal(h["gathered"], torch.from_numpy(x))


def _rank1_of_2():
    """A mesh object placed at rank 1 of 2, without a process group: what
    the loaders read of a mesh."""
    mesh = Mesh((WORLD,), ("data",), "cpu")
    mesh.rank, mesh.world = 1, WORLD
    return mesh


def test_loaders_take_the_ranks_rows():
    items = [{"x": np.full((2,), i, np.float32), "id": f"s{i}"}
             for i in range(7)]
    mesh = _rank1_of_2()
    host = list(Batcher(items, 4, shuffle=True, seed=3))
    dev = list(DeviceBatcher(items, 4, shuffle=True, seed=3, mesh=mesh))
    pre = list(PrefetchBatcher(Batcher(items, 4, shuffle=True, seed=3),
                               "cpu", mesh=mesh))
    assert len(host) == len(dev) == len(pre) == 2
    for h, d, p in zip(host, dev, pre):
        for got in (d, p):
            assert torch.equal(got["x"], torch.from_numpy(h["x"][2:]))
            assert torch.equal(got["sample_mask"],
                               torch.from_numpy(h["sample_mask"][2:]))
        assert d["id"] == h["id"][2:] and p["id"] == h["id"]
    # a batch of 3 does not divide 2 ranks: every rank takes all of it
    whole = next(iter(DeviceBatcher(items, 3, mesh=mesh)))
    assert whole["x"].shape == (3, 2)


# --------------------------------------------------------------------------- #
# (b) the LMA step against JAX's 2-device mesh                                  #
# --------------------------------------------------------------------------- #

def test_lma_step_matches_one_rank_and_jax_mesh_step(dp):
    """Against one port rank on the same weights, tests/test_parallel.py's
    tolerances (JAX's mesh step against its one-device step): total_loss
    rtol 1e-5; the parameters after one Adam step equal but for +-2 lr
    sign flips where the gradient is ~0, on under 1% of the elements; eval
    TOS rtol 1e-5, atol 1e-6. Against JAX's mesh-(2,) step, the port's own
    tolerances against flax on carried weights (its bf16 trunk rounds
    elsewhere: one port rank and one JAX device already differ by 1.9e-5
    relative in total_loss here): loss values 2e-2 relative
    (tests/test_torch_lma_schemes.py), eval TOS within 1.9e-2 of its
    range (the eval gate)."""
    one, ref = dp["one"], dp["jax"]
    lr = 1e-3
    for out in dp["ranks"]:
        lma = out["lma"]
        assert np.isclose(lma["values"]["total_loss"],
                          one["lma_values"]["total_loss"], rtol=1e-5)
        np.testing.assert_allclose(lma["tos"].numpy(),
                                   one["lma_tos"].numpy(), rtol=1e-5,
                                   atol=1e-6)
        total = bad = 0
        for key, want in one["lma_params"]["LMA"].items():
            a, b = lma["params"]["LMA"][key].numpy(), want.numpy()
            mism = ~np.isclose(a, b, rtol=2e-5, atol=2e-6)
            total += a.size
            bad += int(mism.sum())
            if mism.any():
                assert np.abs(a - b)[mism].max() <= 2 * lr + 1e-6, key
        assert bad / total < 0.01, f"{bad}/{total}"
        assert abs(lma["values"]["total_loss"] - ref["lma_total"]) \
            < 2e-2 * abs(ref["lma_total"])
        span = np.ptp(ref["lma_tos"])
        assert np.abs(lma["tos"].numpy() - ref["lma_tos"]).max() \
            <= 1.9e-2 * span


# --------------------------------------------------------------------------- #
# (c) the flagship: 2 ranks against 1, and against JAX                          #
# --------------------------------------------------------------------------- #

def _model_rel_l2(got, want, skip=()):
    """Each model's gradients as one vector (the exact zeros in ``skip``
    left out): relative L2."""
    out = {}
    for name, ref in want.items():
        keys = [k for k in ref if f"{name}.{k}" not in skip]
        out[name] = _rel_l2(
            np.concatenate([got[name][k].numpy().ravel() for k in keys]),
            np.concatenate([ref[k].numpy().ravel() for k in keys]))
    return out


def _zero_biases(cfg):
    """The conv biases that feed a GroupNorm of one channel per group: an
    exact zero gradient, bf16 noise on both sides
    (tests/test_torch_train.py)."""
    out = set()
    for name, mc in cfg["networks"].items():
        module = build_model(mc, n_pairs=T_MYO - 1).module
        out |= {f"{name}.{prefix}.conv.bias"
                for prefix, sub in module.named_modules()
                if hasattr(sub, "conv") and hasattr(sub, "norm")
                and sub.norm.num_groups == sub.norm.weight.numel()}
    return out


def test_flagship_two_ranks_match_one_rank(dp):
    """Loss values within 1e-3 relative at each of 3 steps (measured <=
    8.2e-5: the updates of steps 1 and 2 carry the first step's gradient
    sums in another order), ``max_abs_displacement`` at the first step
    (the same weights; a max, not a loss, so it is not held after
    updates), and the first step's all-reduced gradients within 1e-2
    relative L2 a model (measured <= 1.9e-3)."""
    one = dp["one"]
    for out in dp["ranks"]:
        fl = out["flagship"]
        for i, (got, want) in enumerate(zip(fl["values"],
                                            one["flagship_values"])):
            assert set(got) == set(want)
            for k in want:
                if k != "max_abs_displacement" or i == 0:
                    assert abs(got[k] - want[k]) <= 1e-3 * abs(want[k]), \
                        (i, k)
        errs = _model_rel_l2(fl["grads"], one["flagship_grads"])
        assert max(errs.values()) < 1e-2, errs


def test_flagship_two_ranks_match_jax_mesh_step(dp):
    """tests/test_torch_train.py's step tolerances: loss values 2e-2
    relative, each gradient tensor but the exact zeros 0.1 relative L2 and
    their median 3e-2."""
    ref = dp["jax"]
    zero = _zero_biases(_flagship_config())
    assert len(zero) == 7
    for out in dp["ranks"]:
        values = out["flagship"]["values"][0]
        assert 0.05 < values["max_abs_displacement"] < 11.0
        for k in ("registration_reconstruction", "registration_supervision",
                  "TOS_regression", "total_loss"):
            want = ref["flagship_values"][k]
            assert abs(values[k] - want) < 2e-2 * abs(want), k
        errs = {f"{n}.{k}": _rel_l2(g.numpy(), ref["flagship_grads"][n][k])
                for n, gs in out["flagship"]["grads"].items()
                for k, g in gs.items() if f"{n}.{k}" not in zero}
        assert len(errs) + len(zero) == sum(
            len(g) for g in ref["flagship_grads"].values())
        worst = max(errs, key=errs.get)
        assert errs[worst] < 0.1, (worst, errs[worst])
        assert np.median(list(errs.values())) < 3e-2


# --------------------------------------------------------------------------- #
# (d) an all-padding shard and a replicated batch; (e) the ranks agree          #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("case", ["padded", "replicated"])
def test_batch_equals_one_rank(dp, case):
    """A flagship batch of 4 with 2 real items (rank 1's shard all
    padding: it contributes nothing), and an LMA batch of 5 that does not
    divide 2 ranks (each rank takes all of it, weighted 1/2): values and
    gradients equal one rank's, 1e-5 relative (float sums in another
    order)."""
    one = dp["one"]
    if case == "padded":
        want_v, want_g = one["pad_values"], one["pad_grads"]
    else:
        want_v, want_g = one["lma_values5"], one["lma_grads5"]
    for out in dp["ranks"]:
        src = out["flagship"] if case == "padded" else out["lma"]
        got_v = src["pad_values"] if case == "padded" else src["values5"]
        got_g = src["pad_grads"] if case == "padded" else src["grads5"]
        assert set(got_v) == set(want_v)
        for k in want_v:
            assert abs(got_v[k] - want_v[k]) <= 1e-5 * abs(want_v[k]), k
        errs = _model_rel_l2(got_g, want_g)
        assert max(errs.values()) < 1e-5, errs


def test_ranks_hold_equal_parameters_after_three_steps(dp):
    a, b = (out["flagship"]["params"] for out in dp["ranks"])
    assert set(a) == set(b)
    for name in a:
        for key in a[name]:
            assert torch.equal(a[name][key], b[name][key]), (name, key)
    assert dp["ranks"][0]["flagship"]["values"] == \
        dp["ranks"][1]["flagship"]["values"]


# --------------------------------------------------------------------------- #
# (f) main.run on 2 ranks; (g) C6                                               #
# --------------------------------------------------------------------------- #

def test_main_run_on_two_ranks(dp):
    """Rank 0 alone writes the run's files; both return the metrics of the
    one-rank run, and the saved predictions are its predictions (1e-4 of
    their range: one epoch of summed gradients in another order)."""
    r0, r1 = (out["main"] for out in dp["ranks"])
    assert sorted(set(r0["calls"])) == ["metrics.jsonl", "save",
                                        "save_predictions",
                                        "save_trained_models"]
    assert set(r1["calls"]) == {"no metrics file"}
    assert r0["test_performance"] == r1["test_performance"]
    assert r0["train_loss"] == r1["train_loss"]
    want = dp["one"]["main"]
    for k, v in want["test_performance"].items():
        assert abs(r0["test_performance"][k] - v) <= 1e-4 * max(abs(v), 1), k
    run_dp, run_one = dp["work"] / "run_dp", dp["work"] / "run_one"
    for name in ("val_pred.npy", "test_pred.npy", "model-LMA.pt",
                 "checkpoints/epoch_000000.pt", "metrics.jsonl"):
        assert (run_dp / name).is_file(), name
    for name in ("val_pred.npy", "test_pred.npy"):
        got = np.load(run_dp / name, allow_pickle=True)
        ref = np.load(run_one / name, allow_pickle=True)
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            span = np.ptp(r["TOS_pred"]) or 1.0
            assert np.abs(g["TOS_pred"] - r["TOS_pred"]).max() <= 1e-4 * span


def test_mesh_larger_than_the_world_raises(tmp_path):
    """C6: ``parallel.mesh_shape`` was read by JAX's ``main.run`` and
    ignored by the port's, which trained on one card; it raises now, as
    JAX's does, before any data is read."""
    cfg = _main_config(tmp_path, tmp_path / "out")
    cfg["parallel"] = {"mesh_shape": "2"}
    with pytest.raises(ValueError, match=r"mesh shape \(2,\) needs 2 "
                       r"devices, have 1.*torchrun --nproc-per-node 2"):
        port_main.run(cfg, device="cpu")
    assert not (tmp_path / "out").exists()
