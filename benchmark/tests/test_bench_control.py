"""The control comes out not correct, on the card at each cell's own size.

The control is the reference put in the program's place, computed in
bfloat16 where the configuration states float32 (``reference.ops.
Numerics(lowp=True)``). On three seeds it must fail at least one of the
cell's numbers under the cell's limits. Run on the card:
``python -m pytest benchmark/tests/test_bench_control.py -q``."""

import time

import pytest

from harness import common

SEEDS = [2 ** 31 + 2000, 2 ** 31 + 2001, 2 ** 31 + 2002]


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control is read at the cell's size")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["joint-train", "reg-train"])
def test_training_control_fails(workload):
    device = _card()
    from harness import compare, train_cell
    from reference import train as ref
    from reference.ops import Numerics
    wl = common.workload(workload)
    cfg, traffic = common.config(wl["config"]), common.traffic(wl["traffic"])
    cell = common.cell(workload)
    for seed in SEEDS:
        res, checks = train_cell.run(workload, cfg, traffic, cell, seed, 0,
                                     False, device, time.perf_counter(),
                                     epochs=0)
        assert res["correct"], checks
        kind, pc, slices, n_pairs, spe = res["followed"]
        state = res["state"]
        p0 = {f"{m}.{k}": v for m, s in state.items() for k, v in s.items()}
        batches = train_cell.batches_for(kind, pc, slices,
                                         len(res["prog"]["losses"]), device)

        def follow(num=None):
            start = {m: {k: v.clone() for k, v in s.items()}
                     for m, s in state.items()}
            return ref.follow(kind, pc, start, batches, spe, n_pairs,
                              *(() if num is None else (num,)))
        exact, low = follow(), follow(Numerics(lowp=True))
        control = compare.train_checks(
            cell["limits"], {"losses": low[0], "first": low[1],
                             "after": low[2]}, *exact, p0)
        assert not all(c["ok"] for c in control), control


@pytest.mark.gpu
def test_inference_control_fails():
    device = _card()
    from harness import infer_cell
    from reference.ops import Numerics
    # joint-infer is no cell of BENCHMARK.json yet (PERF.md, section 7); its
    # harness, traffic and limits stay, so that the cell comes as data
    cfg, traffic = common.config("joint"), common.traffic("study-requests")
    cell = common.cell("joint-infer")
    pc = common.program_config(cfg)
    for seed in SEEDS:
        res, checks = infer_cell.run("joint-infer", cfg, traffic, cell, seed,
                                     0, False, device, time.perf_counter(),
                                     requests=110)
        assert res["correct"], checks
        args = (pc, res["pool"], res["kept"], res["state"],
                int(traffic["frames"]) - 1, device)
        _, exact = infer_cell.reference_of(*args)
        _, low = infer_cell.reference_of(*args, Numerics(lowp=True))
        gaps = infer_cell.gaps(low, exact)
        assert any(gaps[k] > limit for k, limit in cell["limits"].items()), \
            gaps
