"""The readings that the limits of ``cells/<workload>.json`` are set from.

    python3 benchmark/tools/readings.py --workload joint-train \
        --seeds 101,102,... [--control-seeds 101,102,103]

On the card, in one process, at the cell's own size. For each seed the
program's numbers against the reference (a training cell: set-up and epoch
0 of the train call, the first steps followed; an inference cell: the
cell's requests, ``--requests`` of them, and the sampled studies
compared). For each control seed also the control's numbers (the
reference in bfloat16 where the configuration states float32, in the
program's place) and the planted faults' numbers: training, half of each
batch left out with the mean taken over the rest; inference, one served
TOS altered by one frame where it is produced. Prints one JSON line a seed
and reading, with the worst leaf of each worst-leaf number; for ``joint``
also the spectrum of the first batch's strain matrices before the rank-5
smoothing, and, with ``--look 23,8``, the reference against itself with
every start weight moved by a relative 2^-23 (about one float32 rounding
step) or 2^-8 (one bfloat16 step, the trunks' precision) normal draw: how
far the seed's own gradient swings with round-off (the look behind the
seeds whose every gap reads high, PERF.md).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path
from statistics import median

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))

from harness import common  # noqa: E402


def worst(gaps):
    k = max(gaps, key=gaps.get)
    return k, gaps[k]


def rms_gap(prog, ref) -> float:
    prog, ref = prog.double(), ref.double().to(prog.device)
    return float((prog - ref).norm() / ref.norm().clamp_min(1e-30))


def strain_spectrum(pc, state, batch, n_pairs):
    """The first batch's strain matrices as the strain head gives them to
    the rank-r smoothing, from the start weights: per slice the singular
    values r and r + 1 over the first, and their ratio, at which the
    smoothing's subspace iteration separates the r-th direction from the
    next: a ratio near 1 would leave its output to round-off."""
    import torch

    from reference import train as ref
    nets = ref.build("joint", pc, n_pairs)
    for name, net in nets.items():
        net.load_state_dict(state[name])
        net.to(batch["cine"].device)
    joint = nets["joint_register_strainmat"]
    seen = []
    hook = joint.strain_head.register_forward_hook(
        lambda mod, inp, out: seen.append(out.detach()))
    with torch.no_grad():
        ref.joint_forward(nets, batch["cine"])
    hook.remove()
    sv = torch.linalg.svdvals(seen[0].double()).cpu()
    r = joint.rank
    ratio = sv[:, r] / sv[:, r - 1]
    worst = int(ratio.argmax())
    return {"sigma_ratio_max": float(ratio.max()),
            "sigma_ratio_median": float(ratio.median()),
            "worst_slice_sigmas_over_first": [
                float(v) for v in (sv[worst, :r + 2] / sv[worst, 0])]}


def train_detail(prog, losses, first, after, p0, compare):
    gnorm = {k: float(v.double().norm()) for k, v in first.items()}
    med = median(gnorm.values())
    keep = {k for k, g in gnorm.items() if g >= compare.SMALL_GRAD * med}
    d_ref = {k: after[k] - p0[k] for k in after}
    d_prog = {k: prog["after"][k] - p0[k] for k in after}
    g_gaps = compare.leaf_gaps(prog["first"], first)
    c_gaps = compare.leaf_gaps(d_prog, d_ref, keep)
    return {"numbers": compare.train_numbers(prog, losses, first, after, p0),
            "loss_gaps": [[compare.rel(a, b) for a, b in zip(pa, pb)]
                          for pa, pb in zip(prog["losses"], losses)],
            "median_grad_gap": median(g_gaps.values()),
            "median_change_gap": median(c_gaps.values()),
            "worst_grad": worst(g_gaps), "worst_change": worst(c_gaps),
            "top_grad": sorted(g_gaps.items(), key=lambda kv: -kv[1])[:4],
            "grad_norm": {k: gnorm[k] for k, _ in sorted(
                g_gaps.items(), key=lambda kv: -kv[1])[:4]},
            "median_grad_norm": med,
            "left_out": sorted(set(first) - keep)}


def self_gaps(state, exact, batches, follow, seed, exponent, device,
              compare):
    """The reference from start weights each moved by a relative
    2^-exponent normal draw, against the reference: the first step's total
    loss, and the first gradient by its worst and its median leaf."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) + 1)
    start = {m: {k: v * (1.0 + 2.0 ** -exponent * torch.randn(
        v.shape, generator=gen, device=device)) for k, v in s.items()}
        for m, s in state.items()}
    losses, first, _ = follow(batches, start=start)
    g = compare.leaf_gaps(first, exact[1])
    return {"exponent": exponent,
            "loss_step1": compare.rel(losses[0][0], exact[0][0][0]),
            "first_grad_worst": worst(g),
            "first_grad_median": median(g.values())}


def train_readings(args, wl, cfg, traffic, cell, device):
    import torch

    from harness import compare, train_cell
    from reference import train as ref
    from reference.ops import Numerics
    limits = {k: math.inf for k in cell["limits"]}
    for seed in args.seeds:
        t0 = time.perf_counter()
        res, _ = train_cell.run(wl["name"], cfg, traffic,
                                dict(cell, limits=limits), seed, 0, False,
                                device, t0, epochs=0)
        kind, pc, slices, n_pairs, spe = res["followed"]
        state, prog = res["state"], res["prog"]
        p0 = {f"{m}.{k}": v for m, s in state.items() for k, v in s.items()}
        batches = train_cell.batches_for(kind, pc, slices,
                                         len(prog["losses"]), device)

        def follow(batches, num=None, frozen=False, start=None):
            start = start or {m: {k: v.clone() for k, v in s.items()}
                              for m, s in state.items()}
            return ref.follow(kind, pc, start, batches, spe, n_pairs,
                              *(() if num is None else (num,)),
                              frozen=frozen)

        exact = follow(batches)
        out = {"seed": seed, "reading": "program",
               **train_detail(prog, *exact, p0, compare)}
        if kind == "joint":
            out["spectrum"] = strain_spectrum(pc, state, batches[0], n_pairs)
        out["self"] = [self_gaps(state, exact, batches, follow, seed, e,
                                 device, compare) for e in args.look]
        print(json.dumps(out, default=str), flush=True)
        if seed in args.control_seeds:
            low = follow(batches, Numerics(lowp=True))
            print(json.dumps({"seed": seed, "reading": "control", **train_detail(
                {"losses": low[0], "first": low[1], "after": low[2]},
                *exact, p0, compare)}, default=str), flush=True)
            half = []
            for b in batches:
                b = dict(b)
                b["mask"] = b["mask"].clone()
                b["mask"][b["mask"].shape[0] // 2:] = 0.0
                half.append(b)
            for name, fault in (("half_batch", follow(half)),
                                ("unchanged", follow(batches, frozen=True))):
                print(json.dumps({"seed": seed, "reading": name, **train_detail(
                    {"losses": fault[0], "first": fault[1],
                     "after": fault[2]}, *exact, p0, compare)}, default=str),
                    flush=True)
        del res, state, prog
        torch.cuda.empty_cache()


def infer_readings(args, wl, cfg, traffic, cell, device):
    import torch

    from harness import infer_cell
    from reference.ops import Numerics
    limits = {k: math.inf for k in infer_cell.GAPS}
    pc = common.program_config(cfg)
    n_pairs = int(traffic["frames"]) - 1
    for seed in args.seeds:
        res, checks = infer_cell.run(wl["name"], cfg, traffic,
                                     dict(cell, limits=limits), seed, 0,
                                     False, device, time.perf_counter(),
                                     requests=args.requests)
        print(json.dumps({"seed": seed, "reading": "program",
                          "numbers": {c["name"]: c["value"] for c in checks}}),
              flush=True)
        if seed in args.control_seeds:
            kept, pool, state = res["kept"], res["pool"], res["state"]
            prog, exact = infer_cell.reference_of(pc, pool, kept, state,
                                                  n_pairs, device)
            _, low = infer_cell.reference_of(pc, pool, kept, state, n_pairs,
                                             device, Numerics(lowp=True))
            for name, got in (("program_rms", prog), ("control", low)):
                print(json.dumps({"seed": seed, "reading": name, "numbers": {
                    **infer_cell.gaps(got, exact),
                    "strain_rms_gap": rms_gap(got["strain_matrix"],
                                              exact["strain_matrix"]),
                    "tos_rms_gap": rms_gap(got["TOS"], exact["TOS"])}}),
                    flush=True)
            prog["TOS"][0, 0] += 1.0
            print(json.dumps({"seed": seed, "reading": "altered_answer",
                              "numbers": infer_cell.gaps(prog, exact)}),
                  flush=True)
        del res
        torch.cuda.empty_cache()


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--requests", type=int, default=110)
    p.add_argument("--look", default="")
    args = p.parse_args()
    args.seeds = [int(s) for s in args.seeds.split(",")]
    args.control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    args.look = [int(e) for e in args.look.split(",") if e]
    common.cache_dirs()
    import torch
    if not torch.cuda.is_available():
        sys.exit("readings are taken on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    wl = common.workload(args.workload)
    cfg, traffic = common.config(wl["config"]), common.traffic(wl["traffic"])
    cell = common.cell(wl["name"])
    print(json.dumps({"card": common.card()}), flush=True)
    if traffic["kind"] == "train_epochs":
        train_readings(args, wl, cfg, traffic, cell, device)
    else:
        infer_readings(args, wl, cfg, traffic, cell, device)


if __name__ == "__main__":
    main()
