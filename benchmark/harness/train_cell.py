"""A training cell: one ``TrainerEngine.train`` call, as ``main.run``
makes it, over data and weights made from the seed.

Set-up builds the engine, its models and its datasets once, and the train
call's first epoch (the eager warm-up step, the graphs' capture, the first
validation and checkpoint) is set-up too. The window is the epochs after
it: from the end of epoch 0 to the end of the last, as the harness's own
tracker sees their ends. Epoch 0's first three steps are the ones the
reference follows: a hook on the engine's per-step schedule call copies the
optimizer's first moments after step 1 and the parameters after step 3,
and the fused epoch's value buffer holds each step's loss.
"""

from __future__ import annotations

import gc
import math
import shutil
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from harness import common, synthetic, weights
from harness.compare import train_checks
from harness.trace import Window


class Tracker:
    """The engine's tracker: the host time of each epoch's end; in a traced
    run the profiler over the window's last ``trace_epochs`` epochs, from
    the end of epoch ``trace_from``."""

    def __init__(self, device, trace_from: Optional[int], trace_epochs: int):
        self.device = device
        self.ends: List[float] = []
        self.trace_from, self.trace_epochs = trace_from, trace_epochs
        self.window: Optional[Window] = None

    def log(self, metrics, step=None) -> None:
        if step is None:
            return
        self.ends.append(time.perf_counter())
        if self.trace_from is None:
            return
        if step == self.trace_from:
            self.window = Window(self.device)
        elif self.window is not None and self.window.t_host1 is None \
                and step == self.trace_from + self.trace_epochs:
            self.window.close()

    def log_best(self, metrics, step=None) -> None:
        pass

    def finish(self) -> None:
        pass


class FirstSteps:
    """Wraps the engine's schedule step (called on the host after every
    train step) to copy the state the reference is compared with."""

    def __init__(self, engine, names: Dict[str, List[str]], n: int = 3):
        self.engine, self.names, self.n = engine, names, n
        self.inner = engine._schedules_step
        self.count = 0
        self.first_moments: Dict[str, torch.Tensor] = {}
        self.params: Dict[str, torch.Tensor] = {}
        self.losses: Optional[torch.Tensor] = None
        self.loss_keys: tuple = ()

    def __call__(self) -> None:
        self.inner()
        self.count += 1
        if self.count == 1:
            for model, (opt, _) in self.engine.optimizers.items():
                for pname, p in zip(self.names[model],
                                    opt.param_groups[0]["params"]):
                    # no moment: the optimizer took no gradient
                    m = opt.state.get(p, {}).get("exp_avg")
                    self.first_moments[f"{model}.{pname}"] = \
                        torch.zeros_like(p) if m is None \
                        else m.detach().clone()
        if self.count == self.n:
            for model, module in self.engine.modules.items():
                for pname, p in module.named_parameters():
                    self.params[f"{model}.{pname}"] = p.detach().clone()
            runner = next(r for r in self.engine._runners.values()
                          if r.after_step is not None)
            self.losses = runner.out[:self.n].detach().clone()
            self.loss_keys = runner.keys


def make_data(cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int):
    rng = np.random.default_rng(int(seed))
    h, w = traffic["frame"]
    slices = synthetic.make_subjects(rng, traffic["subjects"], h, w,
                                     int(traffic["frames"]))
    if cfg["training"]["scheme"] == "reg":
        return slices, synthetic.registration_pairs(slices)
    return slices, slices


def run(workload: str, cfg: Dict[str, Any], traffic: Dict[str, Any],
        cell: Dict[str, Any], seed: int, seconds: float, trace: bool,
        device, t_start: float, epochs: Optional[int] = None):
    """The cell's run; returns (result, checks). ``epochs`` fixes the
    window's epochs (else ``seconds`` over the cell's epoch estimate)."""
    from cardiax_torch.data.datasets import build_datasets
    from cardiax_torch.data.split import split_data
    from cardiax_torch.models import build_model
    from cardiax_torch.train import build_trainer
    from reference import train as ref

    kind = "reg" if cfg["training"]["scheme"] == "reg" else "joint"
    pc = common.program_config(cfg)
    n_window = epochs if epochs is not None else \
        max(2, math.ceil(seconds / float(cell["epoch_seconds"])))
    trace_epochs = min(int(traffic.get("trace_epochs", 2)), n_window - 1)
    stage = common.Stages(t_start)
    pc["training"].update(traffic.get("training", {}))
    pc["training"]["epochs"] = 1 + n_window
    # a directory of this run's own under $TMPDIR, removed at the end
    save_dir = Path(tempfile.mkdtemp(prefix=f"cardiax-bench-{workload}-"))
    pc["saving"]["saving_dir"] = str(save_dir)

    stage("started")
    slices, items = make_data(pc, traffic, seed)
    stage("data made")
    datasets = build_datasets(pc["datasets"], split_data(items,
                                                         pc["data_split"]), pc)
    datasets = {k: v for k, v in datasets.items() if len(v)}
    n_pairs = int(traffic["frames"]) - 1
    frame = tuple(traffic["frame"])
    networks = {name: build_model(mc, n_pairs=n_pairs, frame_size=frame)
                for name, mc in pc["networks"].items()}
    ref_nets = ref.build(kind, pc, n_pairs)
    state = weights.make(weights.shapes_of(ref_nets), seed, device,
                         cfg["bench"]["weight_scales"])
    for name, bundle in networks.items():
        bundle.module.load_state_dict(state[name])
        bundle.initialized = True
    trainer = build_trainer(pc["training"], device, pc)
    names = {n: [k for k, _ in b.module.named_parameters()]
             for n, b in networks.items()}
    hook = FirstSteps(trainer, names, int(traffic.get("first_steps", 3)))
    trainer._schedules_step = hook
    # a traced run profiles the window's last epochs; the rate and the
    # per-epoch host spans are read from the epochs before them
    traced = trace and trace_epochs >= 1
    tracker = Tracker(device, n_window - trace_epochs if traced else None,
                      trace_epochs)
    stage("engine built")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    trainer.train(models=networks, datasets=datasets,
                  trainer_config=pc["training"], full_config=pc,
                  tracker=tracker)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ends = tracker.ends
    stage("epoch 0 (set-up) ended", ends[0])
    stage("window ended", ends[-1])
    window_s = ends[-1] - ends[0]
    n_train = len(datasets["train"])
    samples = (len(ends) - 1) * n_train
    setup_s = ends[0] - t_start
    untraced = n_window - trace_epochs if traced else n_window
    all_rows = trainer.host_profile_rows
    rows = all_rows[1:1 + untraced]
    steps_per_epoch = math.ceil(n_train / int(pc["training"]["batch_size"]))
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    loaded = common.forbidden_loaded()
    engaged = {"last_fuse_engaged": list(trainer.last_fuse_engaged),
               "last_fuse_trainval": trainer.last_fuse_trainval,
               "last_pipeline_engaged": trainer.last_pipeline_engaged}

    cols = [list(hook.loss_keys).index(k)
            for k in ("total_loss", "registration_reconstruction")]
    prog = {"losses": hook.losses[:, cols].double().cpu().tolist(),
            "first": {k: v / (1.0 - 0.9) for k, v in
                      hook.first_moments.items()},
            "after": hook.params}
    window = tracker.window
    # the program's state goes before the reference runs: the hook and the
    # engine hold each other, a cycle that only the collector frees
    del trainer, networks, datasets, hook
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    written = sorted((save_dir / "checkpoints").glob("*"))
    stage(f"{len(ends)} checkpoints of {written[-1].stat().st_size if written else 0}"
          f" bytes each written under $TMPDIR")
    shutil.rmtree(save_dir, ignore_errors=True)

    checks = follow_and_compare(kind, pc, cell, slices, state, prog, n_pairs,
                                steps_per_epoch, device)
    stage("reference compared")
    run_rec = {"kind": "train", "config": cfg, "traffic": traffic,
               "window_s": ends[untraced] - ends[0], "epochs": untraced,
               "samples": untraced * n_train,
               "steps": untraced * steps_per_epoch,
               "steps_per_epoch": steps_per_epoch, "host_rows": rows,
               "kernel_rows": common.kernel_rows(), "trace": None}
    result = {"correct": all(c["ok"] for c in checks),
              "attempted": samples, "failed": 0,
              "engaged": engaged, "peak": peak, "loaded": loaded,
              "setup_s": setup_s, "run": run_rec,
              "train_samples_per_s": samples / window_s if window_s else None,
              "prog": prog, "state": state,
              "followed": (kind, pc, slices, n_pairs, steps_per_epoch)}
    if window is not None:
        window.collect()
        phases = host_phases(all_rows)
        run_rec["trace"] = dict(window.summary(phases),
                                kernels=window.kernels,
                                steps=trace_epochs * steps_per_epoch)
        stage("trace read")
    return result, checks


def host_phases(rows) -> List[tuple]:
    """The engine's host phases of each epoch on the host clock, laid end
    to end back from the epoch's ``t_done`` in the engine's order."""
    order = ("plan", "dispatch", "sync", "val", "track", "beststop", "ckpt")
    out = []
    for ht in rows:
        t = ht["t_done"] - sum(ht.get(k, 0.0) for k in order)
        for k in order:
            if k in ht:
                out.append((k, t, t + ht[k]))
                t += ht[k]
    return out


def batches_for(kind: str, pc, slices, steps: int, device):
    """The first ``steps`` batches of epoch 0, worked out by the reference
    from the raw data: the train split (every subject but the held-out
    ones, in data order), the shuffle of (training seed, 0), batches of
    ``batch_size``. Only the rows of these batches are built."""
    from reference import train as ref
    held = [p.replace(".*", "") for s in ("val", "test")
            for p in pc["data_split"]["splits"][s]["patterns"]]
    bs = int(pc["training"]["batch_size"])
    train = [s for s in slices if s["subject_id"] not in held]
    items = train if kind == "joint" else ref.reg_pairs(train)
    order = ref.epoch_order(int(pc["training"]["seed"]), 0, len(items))
    picked = [items[i] for i in order[:steps * bs]]
    if kind == "joint":
        ds = pc["datasets"]["train"]
        fields = ref.joint_inputs(
            picked, int(ds["n_myo_frames_to_use_for_regression"]),
            int(ds["n_strainmat_frames_to_use_for_regression"]))
    else:
        fields = ref.reg_inputs(train, picked)
    out = []
    for k in range(steps):
        b = {f: torch.from_numpy(v[k * bs:(k + 1) * bs]).to(device)
             for f, v in fields.items()}
        b["mask"] = torch.ones(next(iter(b.values())).shape[0], device=device)
        out.append(b)
    return out


def follow_and_compare(kind, pc, cell, slices, state, prog, n_pairs,
                       steps_per_epoch, device):
    from reference import train as ref
    steps = len(prog["losses"])
    batches = batches_for(kind, pc, slices, steps, device)
    start = {m: {k: v.clone() for k, v in s.items()} for m, s in state.items()}
    losses, first, after = ref.follow(kind, pc, start, batches,
                                      steps_per_epoch, n_pairs)
    p0 = {f"{m}.{k}": v for m, s in state.items() for k, v in s.items()}
    return train_checks(cell["limits"], prog, losses, first, after, p0)
