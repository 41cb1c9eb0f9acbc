"""An inference cell: studies served one after another through
``TrainerEngine.test``, as ``main.run``'s inference calls it.

A request is one study: its slices become a ``JointDataset`` (the
configuration's ``datasets.test``), then ``test(..., target_dataset=...)``
returns each slice's predictions on the host. One client, closed loop: the
next request starts when the last one's predictions are back. A request is
timed from the start of its data step to its predictions. Set-up serves
one study of each batch count the traffic draws (1 and 2 padded batches),
so the eval step's shapes are warm before the window.

The studies that are compared with the reference are drawn from the seed
before the window: ``checked_studies - 1`` of the first ``sample_from``
requests, and the first study of the largest size the traffic draws.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from harness import common, synthetic, weights
from harness.compare import check, prediction_gap
from harness.trace import Window

# compared number -> the prediction it compares
GAPS = {"strain_gap": "strain_matrix", "tos_gap": "TOS",
        "deformed_gap": "deformed_source"}
CHECKED = tuple(GAPS.values())


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0-100) of all values, linear between the two
    nearest ranks (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def studies(rng: np.random.Generator, traffic: Dict[str, Any]):
    """Studies, one after another: each slice count of the traffic's range
    once in every block of studies, in an order drawn from the seed, so
    that every seed serves the same mix; a study's slices are drawn from
    the pool without repeats."""
    lo, hi = traffic["study_slices"]
    pool = int(traffic["pool_slices"])
    counts = np.arange(lo, hi + 1)
    while True:
        for n in rng.permutation(counts):
            yield rng.choice(pool, size=int(n), replace=False)


def sample(seed: int, traffic: Dict[str, Any]) -> set:
    """The request indices checked besides the first largest study."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, 1])
    n = int(traffic.get("sample_from", 100))
    k = min(n, int(traffic.get("checked_studies", 12)) - 1)
    return {int(i) for i in rng.choice(n, size=k, replace=False)}


def run(workload: str, cfg: Dict[str, Any], traffic: Dict[str, Any],
        cell: Dict[str, Any], seed: int, seconds: float, trace: bool,
        device, t_start: float, requests: int = None):
    from cardiax_torch.data.datasets import build_datasets
    from cardiax_torch.models import build_model
    from cardiax_torch.train import build_trainer
    from reference import train as ref

    stage = common.Stages(t_start)
    pc = common.program_config(cfg)
    rng = np.random.default_rng(int(seed))
    h, w = traffic["frame"]
    frames = int(traffic["frames"])
    pool = [synthetic.make_slice(rng, f"SET03-CT{i:02d}", h, w, frames)
            for i in range(int(traffic["pool_slices"]))]
    stage("data made")
    n_pairs = frames - 1
    networks = {name: build_model(mc, n_pairs=n_pairs, frame_size=(h, w))
                for name, mc in pc["networks"].items()}
    state = weights.make(weights.shapes_of(ref.build("joint", pc, n_pairs)),
                         seed, device,
                         cfg["bench"]["weight_scales"])
    for name, bundle in networks.items():
        bundle.module.load_state_dict(state[name])
        bundle.initialized = True
    trainer = build_trainer(pc["training"], device, pc)
    ds_conf = {"test": pc["datasets"]["test"]}
    bs = int(pc["training"]["batch_size"])

    def serve(idx, keys):
        t0 = time.perf_counter()
        ds = build_datasets(ds_conf, {"test": {"data": [pool[i] for i in idx]}},
                            pc)
        t1 = time.perf_counter()
        preds, _, _ = trainer.test(models=networks, datasets=ds,
                                   trainer_config=pc["training"],
                                   target_dataset="test")
        t2 = time.perf_counter()
        keep = {k: np.stack([p[f"{k}_pred"] for p in preds]) for k in keys}
        return t2 - t0, t1 - t0, keep, (t0, t1, t2)

    lo, hi = traffic["study_slices"]
    for k in sorted({lo, min(hi, bs + 1)}):
        serve(np.arange(k), ())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    stage("set-up studies served")

    picks = sample(seed, traffic)
    largest = None
    plan = studies(rng, traffic)
    trace_n = int(traffic.get("trace_studies", 30)) if trace else 0
    lat, data_s, kept, spans = [], [], {}, []
    window = None
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    for i, idx in enumerate(plan):
        if trace and i == 1:
            window = Window(device)
        checked = i in picks or (largest is None and len(idx) == hi)
        if checked and i not in picks:
            largest = i
        total, data, keep, span = serve(idx, CHECKED if checked else ())
        lat.append(total)
        data_s.append(data)
        spans.append(span)
        if checked:
            kept[i] = (idx, keep)
        if window is not None and window.t_host1 is None and i == trace_n:
            window.close()
        if (requests is None and time.perf_counter() - t_window >= seconds) \
                or (requests is not None and i + 1 >= requests):
            break
    window_s = time.perf_counter() - t_window
    stage("window ended")
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    loaded = common.forbidden_loaded()
    if window is not None and window.t_host1 is None:
        window.close()
    del trainer, networks
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks = compare(pc, cell, pool, kept, state, n_pairs, device)
    stage("reference compared")
    run_rec = {"kind": "infer", "config": cfg, "traffic": traffic,
               "window_s": window_s, "requests": len(lat),
               "data_s": data_s, "trace": None}
    if window is not None:
        window.collect()
        phases = [p for t0, t1, t2 in spans
                  for p in (("data", t0, t1), ("test", t1, t2))]
        run_rec["trace"] = dict(window.summary(phases),
                                kernels=window.kernels)
        stage("trace read")
    result = {"correct": all(c["ok"] for c in checks),
              "attempted": len(lat), "failed": 0, "peak": peak,
              "loaded": loaded, "setup_s": setup_s,
              "study_ms_p95": 1e3 * percentile(lat, 95),
              "run": run_rec, "kept": kept, "pool": pool, "state": state}
    print(f"studies: {len(lat)} in {window_s:.3f} s, median "
          f"{1e3 * percentile(lat, 50):.3f} ms, p95 "
          f"{result['study_ms_p95']:.3f} ms", flush=True)
    return result, checks


def reference_of(pc, pool, kept, state, n_pairs, device, num=None):
    """The reference's predictions of the kept studies' slices, and the
    program's, in the same order. Each study runs in the batches the
    program ran it in: ``batch_size`` slices, the last batch filled up by
    repeating its last slice, the fill dropped."""
    from reference import train as ref
    order = sorted(kept)
    t = pc["datasets"]["test"]
    bs = int(pc["training"]["batch_size"])
    outs = []
    for i in order:
        idx = list(kept[i][0])
        idx += [idx[-1]] * (-len(idx) % bs)
        raw = ref.joint_inputs([pool[j] for j in idx],
                               int(t["n_myo_frames_to_use_for_regression"]),
                               int(t["n_strainmat_frames_to_use_for_regression"]))
        out = ref.predict_joint(pc, state,
                                torch.from_numpy(raw["cine"]).to(device),
                                n_pairs, *(() if num is None else (num,)),
                                block=bs)
        outs.append({k: v[:len(kept[i][0])] for k, v in out.items()})
    out = {k: torch.cat([o[k] for o in outs]) for k in CHECKED}
    prog = {k: torch.from_numpy(np.concatenate([kept[i][1][k] for i in order]))
            for k in CHECKED}
    return prog, out


def gaps(prog, out, names=tuple(GAPS)) -> Dict[str, float]:
    """The named numbers of ``GAPS``."""
    return {n: prediction_gap(prog[GAPS[n]], out[GAPS[n]]) for n in names}


def compare(pc, cell, pool, kept, state, n_pairs, device):
    prog, out = reference_of(pc, pool, kept, state, n_pairs, device)
    limits = cell["limits"]
    return [check(k, v, limits[k])
            for k, v in gaps(prog, out, limits).items()]
