"""The benchmark's reference against the program's plain path, at a tiny
size on the CPU (where every kernel of the program runs its plain
version): the same inputs from the raw slices, the same shuffle,
learning rates and start matrix, the same forward, and the same first
gradients (autograd here, the hand-derived adjoints there)."""

import math

import numpy as np
import pytest
import torch

from harness import common, synthetic, weights
from reference import ops as rops
from reference import train as ref

TINY = dict(frame=(32, 32), frames=5)
# a shooting grid of 136x80, over the 128 px of the dense metric and resize
LARGE = dict(frame=(272, 160), frames=3)
SCALES = common.config("joint")["bench"]["weight_scales"]


def tiny_config(name, size=TINY, batch=2):
    pc = common.program_config(common.config(name))
    pc["training"]["batch_size"] = batch
    for d in pc["datasets"].values():
        if "n_myo_frames_to_use_for_regression" in d:
            d["n_myo_frames_to_use_for_regression"] = size["frames"]
    return pc


def slices(n=3, seed=7, size=TINY):
    rng = np.random.default_rng(seed)
    return synthetic.make_subjects(rng, [{"id": "SET02-CT00", "slices": n}],
                                   *size["frame"], size["frames"])


def program_nets(pc, state, size=TINY):
    from cardiax_torch.models import build_model
    nets = {n: build_model(mc, n_pairs=size["frames"] - 1,
                           frame_size=size["frame"]).module
            for n, mc in pc["networks"].items()}
    for n, net in nets.items():
        net.load_state_dict(state[n])
    return nets


def test_inputs_shuffle_rates_and_start_matrix():
    from cardiax_torch.data.datasets import (BasicRegistrationDataset,
                                             JointDataset)
    from cardiax_torch.data.loader import epoch_permutation
    from cardiax_torch.ops.svd_smooth import jax_normal_f32
    from cardiax_torch.train.optim import build_optimizer
    pc = tiny_config("joint")
    data = slices()
    ds = JointDataset(data, dataset_config=pc["datasets"]["train"])
    raw = ref.joint_inputs(data, TINY["frames"], 40)
    for i in range(len(data)):
        np.testing.assert_array_equal(raw["cine"][i], ds[i]["cine_myo_mask"])
        np.testing.assert_array_equal(raw["strain"][i], ds[i]["strain_matrix"])
        np.testing.assert_array_equal(raw["TOS"][i], ds[i]["TOS"])
    pairs = BasicRegistrationDataset(synthetic.registration_pairs(data))
    rr = ref.reg_inputs(data)
    assert len(pairs) == rr["src"].shape[0]
    for i in range(len(pairs)):
        np.testing.assert_array_equal(rr["src"][i], pairs[i]["source_img"])
        np.testing.assert_array_equal(rr["tar"][i], pairs[i]["target_img"])
    for seed, epoch, n in ((2434, 0, 160), (2434, 3, 3040), (2 ** 33 + 1, 1, 7)):
        np.testing.assert_array_equal(ref.epoch_order(seed, epoch, n),
                                      epoch_permutation(seed, epoch, n))
    np.testing.assert_array_equal(rops.start_matrix(40, 5),
                                  jax_normal_f32(40, 5))
    for conf in pc["training"]["optimizers"].values():
        p = torch.nn.Parameter(torch.zeros(3))
        _, sched = build_optimizer([p], conf, steps_per_epoch=16)
        for step in range(600):
            assert ref.lr_at(conf, 16, step) == pytest.approx(
                sched._last_lr[0], rel=1e-12)
            sched.step()


@pytest.mark.parametrize("name, size, dense, total_rel", [
    pytest.param("joint", TINY, False, 1e-5, id="joint"),
    pytest.param("reg", TINY, False, 1e-5, id="reg"),
    pytest.param("joint", LARGE, False, 1e-3, id="joint-272x160"),
    pytest.param("reg", LARGE, False, 1e-5, id="reg-272x160"),
    pytest.param("joint", LARGE, True, 1e-5, id="joint-272x160-dense")])
def test_forward_and_first_gradients_equal_the_programs(monkeypatch, name,
                                                        size, dense,
                                                        total_rel):
    """At 272x160 both sides take their FFT forms of the metric and the
    resize (the program its ``rfft2`` branches), whose float32 round-off
    differs by about 2.5e-7. The registration's outputs (deformed source,
    velocity, momentum) are held to that directly: over 12 seeds of
    weights and slices they read at most 3.3e-7 relative L2 at 272x160
    and 0 at 32x32, where a metric whose alpha is 0.1% off reads 2.1e-5
    and an unhalved Nyquist split 2.9e-4 on the deformed source; the
    limit is 2e-6. The strain head takes the displacement video in
    bfloat16, where so small a difference flips roundings: the strain
    matrix departs by 5e-4 to 1.6e-3 and joint's total by 2.1e-5 to
    7.9e-4 over those 12 seeds (1.6e-4 on this test's), so the total is
    held at 1e-3 there. With both sides held to their dense forms
    (``-dense``) the total is the reference's within 1e-5 again."""
    from cardiax_torch.losses.calculator import LossCalculator
    from cardiax_torch.ops import fluid_metric
    from cardiax_torch.train import build_trainer
    if dense:
        monkeypatch.setattr(rops, "DENSE_MAX_SIDE", 10 ** 9)
        monkeypatch.setattr(fluid_metric, "_MM_MAX_SIDE", 10 ** 9)
    pc = tiny_config(name, size)
    kind = "reg" if name == "reg" else "joint"
    rnets = ref.build(kind, pc, size["frames"] - 1)
    state = weights.make(weights.shapes_of(rnets), 2 ** 31 + 11, "cpu", SCALES)
    for n, net in rnets.items():
        net.load_state_dict(state[n])
    pnets = program_nets(pc, state, size)
    data = slices(size=size)
    if kind == "joint":
        raw = ref.joint_inputs(data[:2], size["frames"], 40)
        batch = {k: torch.from_numpy(v) for k, v in
                 (("cine", raw["cine"]), ("strain", raw["strain"]),
                  ("TOS", raw["TOS"]))}
        arrays = {"cine_myo_mask": batch["cine"],
                  "strain_matrix": batch["strain"], "TOS": batch["TOS"]}
    else:
        raw = ref.reg_inputs(data[:1])
        batch = {"src": torch.from_numpy(raw["src"][:2]),
                 "tar": torch.from_numpy(raw["tar"][:2])}
        arrays = {"source_img": batch["src"], "target_img": batch["tar"]}
    batch["mask"] = arrays["sample_mask"] = torch.ones(2)
    with torch.no_grad():
        if kind == "joint":
            out_r = ref.joint_forward(rnets, batch["cine"])
            cine = batch["cine"]
            out_p = pnets["joint_register_strainmat"](
                cine[:, :, :1].expand(-1, -1, cine.shape[2] - 1, -1, -1),
                cine[:, :, 1:])
        else:
            out_r = rnets["registration"](batch["src"], batch["tar"])
            out_p = pnets["registration"](batch["src"], batch["tar"])
    for k in ("deformed_source", "velocity", "momentum"):
        a, b = out_p[k].double(), out_r[k].double()
        assert float((a - b).norm()) <= 2e-6 * float(b.norm()), k
    trainer = build_trainer(pc["training"], "cpu", pc)
    trainer.modules = pnets
    preds, targets = trainer.scheme.forward(pnets, arrays)
    total_p, values_p = LossCalculator(pc["losses"])(preds, targets)
    total_r, recon_r = ref.loss(kind, pc, rnets, batch)
    assert float(recon_r) == pytest.approx(
        float(values_p["registration_reconstruction"]), rel=1e-5)
    assert float(total_p) == pytest.approx(float(total_r), rel=total_rel)
    total_p.backward()
    total_r.backward()
    # the bfloat16 trunks' weight gradients are bfloat16: the hand-derived
    # adjoints' float32 round-off flips their last bit here and there
    for n in pnets:
        pg = dict(pnets[n].named_parameters())
        for k, p in rnets[n].named_parameters():
            g_ref, g_prog = p.grad.double(), pg[k].grad.double()
            assert float((g_prog - g_ref).norm()) <= \
                1e-2 * float(g_ref.norm()) + 1e-12, (n, k)


def test_control_departs_from_the_exact_reference():
    pc = tiny_config("joint")
    rnets = ref.build("joint", pc, TINY["frames"] - 1)
    state = weights.make(weights.shapes_of(rnets), 5, "cpu", SCALES)
    cine = torch.from_numpy(ref.joint_inputs(slices(2), TINY["frames"],
                                             40)["cine"])
    exact = ref.predict_joint(pc, state, cine, TINY["frames"] - 1)
    low = ref.predict_joint(pc, state, cine, TINY["frames"] - 1,
                            rops.Numerics(lowp=True))
    gap = float((low["strain_matrix"] - exact["strain_matrix"]).abs().max()
                / exact["strain_matrix"].abs().max())
    assert 1e-4 < gap < 1.0 and math.isfinite(gap)


@pytest.mark.parametrize("kind", ["joint", "reg"])
def test_batches_for_builds_only_the_followed_rows(kind):
    """The followed batches equal those cut from the inputs of the whole
    train split in the epoch's order."""
    from harness import train_cell
    pc = tiny_config(kind, batch=3)
    data = slices(8)
    got = train_cell.batches_for(kind, pc, data, 2, torch.device("cpu"))
    if kind == "joint":
        whole = ref.joint_inputs(data, TINY["frames"], 40)
        whole = {k: whole[k] for k in ("cine", "strain", "TOS")}
    else:
        whole = ref.reg_inputs(data)
    n = next(iter(whole.values())).shape[0]
    order = ref.epoch_order(int(pc["training"]["seed"]), 0, n)
    assert len(got) == 2
    for k, b in enumerate(got):
        idx = order[3 * k:3 * (k + 1)]
        assert sorted(b) == sorted([*whole, "mask"])
        for f, v in whole.items():
            assert torch.equal(b[f], torch.from_numpy(v[idx])), f
        assert torch.equal(b["mask"], torch.ones(3))


# the reference's first step at TINY's sizes, pinned when the FFT forms
# came in: at sides of 128 px and under the dense path is unchanged
PINNED = {
    "joint": {"total": 164.35166931152344, "recon": 16.048864364624023,
              "joint_register_strainmat": 3799.3078, "LMA": 0.025275032047211984},
    "reg": {"total": 13.679003715515137, "recon": 13.679003715515137,
            "registration": 117.76432},
}


@pytest.mark.parametrize("kind", ["joint", "reg"])
def test_reference_first_step_is_pinned(kind):
    pc = tiny_config(kind)
    rnets = ref.build(kind, pc, TINY["frames"] - 1)
    state = weights.make(weights.shapes_of(rnets), 2 ** 31 + 11, "cpu", SCALES)
    for n, net in rnets.items():
        net.load_state_dict(state[n])
    data = slices()
    if kind == "joint":
        raw = ref.joint_inputs(data[:2], TINY["frames"], 40)
        batch = {k: torch.from_numpy(raw[k]) for k in ("cine", "strain", "TOS")}
    else:
        raw = ref.reg_inputs(data[:1])
        batch = {k: torch.from_numpy(raw[k][:2]) for k in ("src", "tar")}
    batch["mask"] = torch.ones(2)
    total, recon = ref.loss(kind, pc, rnets, batch)
    total.backward()
    pin = PINNED[kind]
    assert float(total.detach()) == pytest.approx(pin["total"], rel=1e-7)
    assert float(recon.detach()) == pytest.approx(pin["recon"], rel=1e-7)
    for name, net in rnets.items():
        g = torch.cat([p.grad.double().ravel() for p in net.parameters()])
        # the gradient's norm moves with the thread count by about 1e-8
        assert float(g.norm()) == pytest.approx(pin[name], rel=1e-6), name
