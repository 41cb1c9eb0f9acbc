"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
cell's run on the CPU at a tiny size, with the cell's own limits, after
planting one fault in the program: a train step that returns its state
unchanged, half of each batch left out with the mean taken over the rest,
or a served answer altered where it is produced. (The cells run on one
card: there is no exchange between cards to leave out.)"""

import time

import pytest
import torch

from harness import common, infer_cell, train_cell

CPU = torch.device("cpu")


def tiny(name, traffic):
    cfg = common.config(name)
    cfg["training"]["batch_size"] = 2
    for d in cfg["datasets"].values():
        if "n_myo_frames_to_use_for_regression" in d:
            d["n_myo_frames_to_use_for_regression"] = 5
    tr = common.traffic(traffic)
    tr.update(frame=[32, 32], frames=5)
    if traffic == "train-epochs":
        tr["subjects"] = [{"id": "SET02-CT00", "slices": 4},
                          {"id": "SET02-CT01", "slices": 4},
                          {"id": "SET01-CT14", "slices": 2}]
    else:
        tr.update(pool_slices=8, study_slices=[1, 3], checked_studies=3,
                  sample_from=4)
    return cfg, tr


def train_run(name, workload, seed=2 ** 31 + 21):
    cfg, tr = tiny(name, "train-epochs")
    if name == "reg":
        tr["subjects"] = tr["subjects"][:1] + tr["subjects"][2:]
    return train_cell.run(workload, cfg, tr, common.cell(workload), seed, 0,
                          False, CPU, time.perf_counter(), epochs=0)


def failed(checks):
    return sorted(c["name"] for c in checks if not c["ok"])


@pytest.mark.parametrize("name, workload", [("joint", "joint-train"),
                                            ("reg", "reg-train")])
def test_state_left_unchanged(monkeypatch, name, workload):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    result, checks = train_run(name, workload)
    assert not result["correct"]
    assert any(n.startswith("change_gap") for n in failed(checks))


def _half_batch(forward):
    def wrapped(self, modules, arrays):
        preds, targets = forward(self, modules, arrays)
        mask = targets["sample_mask"].clone()
        mask[mask.shape[0] // 2:] = 0.0
        targets["sample_mask"] = mask
        return preds, targets
    return wrapped


@pytest.mark.parametrize("name, workload", [("joint", "joint-train"),
                                            ("reg", "reg-train")])
def test_half_the_batch_left_out(monkeypatch, name, workload):
    from cardiax_torch.train.schemes.joint_reg_strainmat_lma import \
        JointRegisterStrainmatLMAScheme
    from cardiax_torch.train.schemes.reg import RegScheme
    cls = RegScheme if name == "reg" else JointRegisterStrainmatLMAScheme
    monkeypatch.setattr(cls, "forward", _half_batch(cls.forward))
    result, checks = train_run(name, workload)
    assert not result["correct"]
    assert failed(checks)


def test_answer_altered_where_produced(monkeypatch):
    from cardiax_torch.models.lma_net import NetStrainMat2LMA
    forward = NetStrainMat2LMA.forward

    def altered(self, strain_matrix):
        out = forward(self, strain_matrix)
        tos = out["TOS"].clone()
        tos[0, 0] += 1.0
        return {"TOS": tos}
    monkeypatch.setattr(NetStrainMat2LMA, "forward", altered)
    cfg, tr = tiny("joint", "study-requests")
    result, checks = infer_cell.run("joint-infer", cfg, tr,
                                    common.cell("joint-infer"), 2 ** 31 + 5,
                                    0, False, CPU, time.perf_counter(),
                                    requests=5)
    assert not result["correct"]
    assert "tos_gap" in failed(checks)
