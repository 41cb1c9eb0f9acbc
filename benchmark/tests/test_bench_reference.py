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
SCALES = common.config("joint")["bench"]["weight_scales"]


def tiny_config(name):
    pc = common.program_config(common.config(name))
    pc["training"]["batch_size"] = 2
    for d in pc["datasets"].values():
        if "n_myo_frames_to_use_for_regression" in d:
            d["n_myo_frames_to_use_for_regression"] = TINY["frames"]
    return pc


def slices(n=3, seed=7):
    rng = np.random.default_rng(seed)
    return synthetic.make_subjects(rng, [{"id": "SET02-CT00", "slices": n}],
                                   *TINY["frame"], TINY["frames"])


def program_nets(pc, state):
    from cardiax_torch.models import build_model
    nets = {n: build_model(mc, n_pairs=TINY["frames"] - 1,
                           frame_size=TINY["frame"]).module
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


@pytest.mark.parametrize("name", ["joint", "reg"])
def test_forward_and_first_gradients_equal_the_programs(name):
    from cardiax_torch.losses.calculator import LossCalculator
    from cardiax_torch.train import build_trainer
    pc = tiny_config(name)
    kind = "reg" if name == "reg" else "joint"
    rnets = ref.build(kind, pc, TINY["frames"] - 1)
    state = weights.make(weights.shapes_of(rnets), 2 ** 31 + 11, "cpu", SCALES)
    for n, net in rnets.items():
        net.load_state_dict(state[n])
    pnets = program_nets(pc, state)
    data = slices()
    if kind == "joint":
        raw = ref.joint_inputs(data[:2], TINY["frames"], 40)
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
    trainer = build_trainer(pc["training"], "cpu", pc)
    trainer.modules = pnets
    preds, targets = trainer.scheme.forward(pnets, arrays)
    total_p, values_p = LossCalculator(pc["losses"])(preds, targets)
    total_r, recon_r = ref.loss(kind, pc, rnets, batch)
    assert float(recon_r) == pytest.approx(
        float(values_p["registration_reconstruction"]), rel=1e-5)
    assert float(total_p) == pytest.approx(float(total_r), rel=1e-5)
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
