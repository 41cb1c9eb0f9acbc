#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``cardiax_torch``).

    python3 chip_smoke.py [--profile DIR] [--baseline DIR]

Needs one CUDA device and ``nvcc``; exits non-zero on any failure and
prints no result without CUDA. Phases, one line each:

1. build: compile every kernel of the paths below from
   ``cardiax_torch/csrc`` (one nvcc per source, in parallel) and print the
   card's name and power limit as ``nvidia-smi`` reports them;
2. kernels: each kernel (K1, K2, K6 forward; K3, K4, K5, K7 backward)
   against its plain PyTorch version, with the displacement clamp and the
   border clip biting, at the flagship shapes and at those of the TPU
   kernels it stands for (K1/K4 at C = 1 at 384x384 and 768x512 frames;
   K1 also at C = 1, 2, 3 on widths that are no multiple of 4; K4 also on
   such a width, at C = 3, over 65,600 items and with samples held on the
   last row and column; K3 at R = 1, 2 and 3, at the in-scan grid of
   768x512 frames, at ragged shapes and at runtime radii of 18-70; K5
   at the in-scan grid of 768x512 frames, the flagship's final warp and
   768x512 frames, and at its hard cases: a convergent field, the clip
   holding whole rows, integer displacements, frames that are no multiple
   of its tile; K1, K3, K4 and K5 with two launches bit-identical; K6/K7 at
   64^2 and 128^2 items, the largest the fused solve takes, at a ragged
   (7, 2, 52, 36), at N = 1, K7 also at R = 1, 3 and the 4x4 minimum, with
   two launches bit-identical); its time (CUDA
   events around 20 calls of the wrapper, and its kernels' own device time
   from the profiler), its byte/operation bound, the plain version's time
   and, where one exists, one PyTorch call computing the same function,
   timed both ways (for K6/K7 the unfused pair of solve and K2/K3 instead,
   and beside their bound on the tensor cores in 3xTF32 the earlier bound
   on the f32 CUDA cores);
3. slice: ``TrainerEngine.test`` over 2 batches (the last one padded) at the
   full width of ``configs/joint.json`` (batch 10, 128^2, T=20, Ts=40, 126
   sectors, 5 Euler steps) with random weights from a seeded generator;
   finite losses, the kernels' launch counts, kernel vs plain on the same
   eval step, and the eval step's time;
4. train: ``cardiax_torch.main.run`` on ``configs/joint.json`` at full width
   with only its data, split, epochs and saving_dir changed, for 2 epochs
   over a synthetic npy (train 25 slices in 3 batches, the last one padded;
   val 5; test 5): finite losses each epoch, the exact launch counts of the
   four kernels, a checkpoint each epoch (host time and size) and the
   periodic figures (or the warning that skipped them: the card's machine
   may lack matplotlib); then ``training.resume`` to a third epoch (it must
   start at epoch 2 with the file's parameters, optimizer and schedule
   state bit for bit, launch one epoch's kernels plus the final
   evaluations, and keep finite losses) and ``training.inference_only``
   (the saved models alone: no backward kernel, the resumed run's metrics
   within 1e-4 relative). The dispatch keys stay at JAX's ``auto``: the
   datasets go to the card, train and val run fused (the train and eval
   steps CUDA graphs, replayed over the epoch plan) in one combined pass,
   unpipelined since checkpoints are on; the train phase gates on that and
   on the exact launches under replay;
4b. dispatch: the train phase, the resume and this phase run under
   PyTorch's deterministic mode (``device.deterministic``: cuDNN's
   deterministic algorithms; an op without a deterministic version on the
   card raises). The step loop (``epoch_fuse: false, device_data_cache:
   false``, its host batches through ``PrefetchBatcher``) twice, to learn
   whether it reproduces itself bit for bit; the fused run against it
   (``torch.equal`` metrics, parameters and optimizer state if it does,
   else total loss and each model's move from the common start within 4x
   the loop's own spread); two controls, the fused run with a planted
   fault (the registration net's optimizer never steps; the learning
   rates one step late), which that gate must fail; ``save_checkpoint:
   false``, which must pipeline, ``torch.equal`` to the unpipelined fused
   run; the fused resume to a third epoch ``torch.equal`` to an
   uninterrupted 3-epoch fused run; three 768x512 train steps, warmed up,
   captured and replayed, ``torch.equal`` to three eager steps (cuFFT
   under capture); ``PrefetchBatcher`` over the flagship's host loader
   ``torch.equal`` to its batches; ``engine.test`` with ``eval_pipeline``
   on and off (``torch.equal`` predictions); then, outside the
   deterministic mode, each epoch's host wall of the 2-epoch run in turns
   step loop, fused, pipelined, pipelined, fused, step loop, and in turns
   loop, graph, graph, loop the host time, device time, idle share and
   peak memory of the flagship train step, the flagship eval step and the
   reg train step, with one replayed epoch's counted K1-K4 launches held to the
   kernels in its profiler trace;
4c. dp: data parallel (``cardiax_torch.parallel``). dp1, inside the
   deterministic mode: the train phase's ``main.run`` with
   ``parallel.mesh_shape: "1"`` over a world-1 NCCL process group, the
   fused epoch captured with the NCCL all-reduces inside: metrics,
   parameters and optimizer state ``torch.equal`` to the train phase's
   run without a mesh, exact launches under replay, and the all-reduces
   each captured step holds. dp2: two gloo ranks on this card (this script
   started again with hidden ``--dp-*`` arguments, its output captured),
   the flagship at full width, batch 10 = 5 slices a rank, 3 steps of the
   step loop, against one process summing the same shards and against one
   rank on the full batch (``run_dp_ranks``), ``engine.test``'s gathered
   predictions, exact launches a rank, ``epoch_fuse: true`` raising with
   gloo's reason; each rank's step host and device time and the gradient
   all-reduce's time and bytes. dp_cards: where two or more cards are
   visible, min(4, cards) NCCL ranks, one a card, the step a CUDA graph,
   with dp2's gates; else it says it was skipped;
5. train step: kernel path vs plain path on one train step (loss and every
   parameter's gradient), a 10-step overfit of one batch, and the train
   step's time;
6. ops: the public ops with field gradients at the flagship's item shape
   (190 items of 128^2): ``expmap_svf`` (R=8, 4 squarings),
   ``compose_displacements`` with the banded single-channel warp (R=12) and
   ``deform_image(img_const=False)`` (R=12), forward and gradients, against
   the same ops through the plain versions, with exact launch counts;
7. large frames: ``cardiax_torch.main.run`` on ``configs/joint.json``'s
   networks, losses and optimizers at clinical 768x512 frames with the
   settings of ``tools/bench_large.py`` (batch 2, T=8, Ts=16, 5 Euler steps
   on the 384x256 grid, final-warp radius 12) for 2 epochs: finite losses
   and exact launch counts; then one train step kernel vs plain, the train
   step's host and device time and its peak device memory;
8. solve: with ``cardiax_torch.ops.shooting._FUSED_SOLVE = True``, the
   train phase's ``main.run`` again (every Euler step through K6/K7, exact
   launch counts), one train step kernel vs plain, the fused solve vs the
   separate one on one train step, and the train step's host and device
   time with each;
9. reg: ``cardiax_torch.main.run`` on ``configs/reg.json`` at its full
   width (16 features, 3 levels, 5 Euler steps, batch 10, final-warp radius
   12) over frame pairs of synthetic 128^2 slices with T=20 (train 40, val
   10, test 10) for 2 epochs with checkpoints: finite losses, the exact
   launches of K1-K4 (K5-K7: 0); one reg train step kernel vs plain, and
   its host and device time and peak device memory;
10. schemes: ``cardiax_torch.main.run`` on configs/lma.json,
   lma_classification.json, strainmat_pred.json, strainmat_lma.json and
   joint_reg_regression.json as written but for data, split, epochs (2)
   and saving_dir, over synthetic 128^2 slices with T=20 and displacement
   fields (frame pairs for the last): finite losses each epoch, JAX's
   metric keys, a checkpoint each epoch, and for joint_registration_
   regression the exact launches of K1-K4 (K5-K7: 0); its train step on
   slice batches of 4 slices x 19 pairs (76 items of 128^2) kernel vs
   plain, with its host and device time and peak device memory; the
   train step time of the other four configs;
11. analytic: ``cardiax_torch.data.load_data`` with the preprocessing
   chain and augmentation (160^2 synthetic slices, T=20, cropped to 144^2,
   resized to 128^2, masked out, 2 rotated and translated variants a slice
   through the native C++ engine, which must build; host time a slice),
   then ``main.run`` on configs/joint.json with ``strainmat_net_type:
   "analytic"`` for 2 epochs (train 36 slices, val 3, test 3) under JAX's
   ``auto`` dispatch: finite losses each epoch, exact K1-K4 launches under
   replay, 128^2 frames resident; one analytic train step kernel vs plain;
   the strain op on that step's displacements in f32 on the card against
   float64 (1e-5 of the range; arctan2 ties reported apart); the analytic
   and the ResNet3D train steps, loop and graph, in turns (host, device,
   peak memory);
12. kfold: ``cardiax_torch.kfold.run_kfold`` on configs/joint.json
   (ResNet3D) over 2 folds of synthetic subjects at 1 epoch each: finite
   ``fold{i}/`` metrics and their average, each fold's exact K1-K4
   launches;
13. export: ``cardiax_torch.main.run`` on configs/joint.json at full width
   as written but for data, split, epochs (2: the momentum head is zero at
   init) and saving_dir, with ``saving.save_model_method: "jit"``; the
   joint network exported once more with ``shooting._FUSED_SOLVE``; a
   fresh ``python3`` that imports only ``cardiax_torch`` loads the three
   ``.pt2`` programs and calls each on a held test batch: exact launches
   (the joint program 5 K2 and 1 K1, the LMA program none, the
   fused-solve one 5 K6 and 1 K1), outputs against the eager modules
   loaded from the ``.pt`` files (float32 registration outputs within
   1e-5 of their range, the bf16-trunk ones within 1.9e-2); a
   ``model_zip_state_dict`` export (``csrc/*.cu``, ``params.pt`` equal to
   the state dict); the 3D activation map of the run's ``val_pred.npy``;
   export time, ``.pt2`` size, load time, and one call exported against
   eager in turns (host and device time);
14. the kernel table as one JSON line, then the result line
   ``{"ok": true, "device": {...}}``.

``--profile DIR`` also writes ``torch.profiler`` tables of eval steps and
train steps to ``DIR/eval_profile.txt``, ``DIR/train_profile.txt``,
``DIR/large_train_profile.txt``, ``DIR/solve_train_profile.txt``,
``DIR/reg_train_profile.txt``, ``DIR/regression_train_profile.txt`` and
``DIR/analytic_train_profile.txt`` (the analytic step, eager),
and of the dispatch phase's timed steps, each mode apart, to
``DIR/dispatch_<step>_{loop,graph}_profile.txt``.
``--baseline DIR`` builds the kernels of DIR (a checkout of an earlier
commit, ``git archive``) as well, times each kernel alone in turns with
this tree's (baseline, this, this, baseline), says whether K1's, K3's
and K4's outputs are bit-identical to the baseline's, and times the
replayed flagship and reg train steps' device time in the same turns, each
turn on a graph captured with that tree's kernels.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import json
import math
import subprocess
import sys
import tempfile
import time
import types
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM data sheet, f32 outside tensor cores
TF32_FLOPS_PER_S = 495e12      # H100 SXM data sheet, dense TF32 tensor cores


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, names=None, iters: int = 20, warmup: int = 3):
    """Mean device time of ``fn()`` over ``iters`` calls from a
    ``torch.profiler`` trace: the summed durations of the CUDA kernels whose
    name contains one of ``names``, or of every device event of the calls
    when ``names`` is None. A trace whose event count is not the same for
    every call is taken again once; None (not measured) when the trace
    holds no device events or no whole number of them a call."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and (names is None or any(n in e.name for n in names))]
        if events and len(events) % iters == 0:
            return sum(e.time_range.elapsed_us() for e in events) / iters / 1e3
    return None


def times(fn, names, plain, lib=None, plain_iters: int = 20, turn_fn=None):
    """The timing keys of a kernel's entry: ``ms`` (CUDA events around 20
    calls of its wrapper), ``kernel_ms`` (the device time of its kernels,
    ``names``, alone), ``plain_ms``, and for the one PyTorch call computing
    the same function ``library_ms`` and ``library_kernel_ms`` (every
    device event of the call), None without one. With ``--baseline``, the
    kernel alone is timed in turns baseline, this tree, this tree, baseline
    (``baseline_kernel_ms``, ``kernel_ms_turns``), each turn through
    ``turn_fn`` where given (a launch both trees' kernels take), else
    ``fn``."""
    out = {"ms": time_ms(fn)}
    if BASELINE:
        turns = []
        for base in (True, False, False, True):
            with baseline_kernels(base):
                turns.append(device_ms(turn_fn or fn, names))
        out["kernel_ms"] = mean_or_none(turns[1:3])
        out["baseline_kernel_ms"] = mean_or_none(turns[0::3])
        out["kernel_ms_turns"] = turns
    else:
        out["kernel_ms"] = device_ms(fn, names)
    out.update(
        plain_ms=time_ms(plain, iters=plain_iters,
                         warmup=3 if plain_iters >= 20 else 1),
        library_ms=None if lib is None else time_ms(lib),
        library_kernel_ms=None if lib is None else device_ms(lib))
    return out


def mean_or_none(xs):
    return None if any(x is None for x in xs) else sum(xs) / len(xs)


# ``--baseline DIR``: the libraries built from DIR/cardiax_torch/csrc (a
# checkout of an earlier commit whose kernels have the same C interface)
BASELINE: dict = {}


def build_baseline(root: Path) -> None:
    """Compile the baseline's kernels, one nvcc per source, all started
    together, into ``root/cardiax_torch/_build``, and load them."""
    import ctypes

    from cardiax_torch.kernels import build
    out_dir = root / "cardiax_torch" / "_build"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("mc_warp", "epdiff_step"):
        lib = out_dir / f"lib{name}-baseline.so"
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
             str(root / "cardiax_torch" / "csrc" / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        require(proc.returncode == 0, f"baseline {name}.cu: {log}")
        BASELINE[name] = ctypes.CDLL(str(lib))
    print(f"baseline: kernels of {root} built for the before/after times")


@contextlib.contextmanager
def baseline_kernels(on: bool = True):
    """Inside, every kernel wrapper launches the baseline's kernel."""
    from cardiax_torch.kernels import build
    saved = {name: build.load_library(name) for name in BASELINE}
    try:
        if on:
            build._loaded.update(BASELINE)
        yield
    finally:
        build._loaded.update(saved)


def same_as_baseline(what, launch, outs) -> str:
    """The text of a check's comparison with the baseline kernel on the
    same inputs: bit-identical, or the largest difference."""
    if not BASELINE:
        return ""
    with baseline_kernels():
        base = launch()
    torch.cuda.synchronize()
    base = base if isinstance(base, tuple) else (base,)
    outs = outs if isinstance(outs, tuple) else (outs,)
    if all(torch.equal(a, b) for a, b in zip(outs, base)):
        return f"; {what} bit-identical to the baseline's"
    diffs = ", ".join(
        f"{(a - b).abs().max().item():.3e} at {int((a != b).sum().item())} "
        f"elements" for a, b in zip(outs, base))
    return f"; {what} differs from the baseline's by up to [{diffs}]"


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def time_text(t, bound_ms, bound_by, lib_name=None) -> str:
    """The timing part of a check's line."""
    text = (f"{t['ms']:.4f} ms (kernel alone {fmt_ms(t['kernel_ms'])}"
            + (f"; baseline's kernel alone {fmt_ms(t['baseline_kernel_ms'])},"
               f" turns baseline, this, this, baseline: "
               f"{', '.join(fmt_ms(x) for x in t['kernel_ms_turns'])}"
               if "baseline_kernel_ms" in t else "")
            + f") vs bound {bound_ms:.4f} ms ({bound_by}), plain "
            f"{t['plain_ms']:.4f} ms")
    if lib_name is None:
        return text + ", no single-call yardstick"
    return (text + f", {lib_name} {t['library_ms']:.4f} ms (kernels alone "
            f"{fmt_ms(t['library_kernel_ms'])})")


def bound(n_bytes: float, n_ops: float, mm_flops: float = 0.0):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and the
    operations' time: f32 operations over the f32 peak, plus matrix-product
    flops run in 3xTF32 (three TF32 products each) over the TF32 tensor
    cores' peak."""
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    o_ms = (n_ops / F32_FLOPS_PER_S + 3 * mm_flops / TF32_FLOPS_PER_S) * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def smooth(gen, shape, scale, device):
    """A smooth random field with max |value| = scale, made on the host."""
    x = torch.randn(shape, generator=gen)
    x = torch.nn.functional.avg_pool2d(x.reshape(-1, 1, *shape[-2:]), 9, 1, 4,
                                       count_include_pad=False).reshape(shape)
    return (x / x.abs().max() * scale).contiguous().to(device)


def phase_build():
    from cardiax_torch.kernels import build
    t0 = time.perf_counter()
    build.build(["mc_warp", "epdiff_step"])
    for name in ("mc_warp", "epdiff_step"):
        build.load_library(name)
    secs = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f"build: mc_warp.cu (K1, K4, K5) + epdiff_step.cu (K2, K3, K6, "
          f"K7) with nvcc for sm_90a in {secs:.2f} s")
    print(card)
    return card


def clip_shares(disp, r):
    """(clamped, clipped): the shares of pixels where |disp| > r - 1 and
    where the clamped row coordinate leaves the frame."""
    h = disp.shape[-2]
    clamped = (disp.abs() > r - 1).any(dim=1).float().mean().item()
    ii = torch.arange(h, device=disp.device).view(1, h, 1).float()
    cy = ii + disp[:, 0].clamp(-(r - 1), r - 1)
    clipped = ((cy < 0) | (cy > h - 1)).float().mean().item()
    require(clamped > 0 and clipped > 0,
            f"check at {tuple(disp.shape)}: clamp/clip do not bite")
    return clamped, clipped


def sample_grid(disp, r):
    """grid_sample's grid for the pre-clamped displacement (border padding
    = the coordinate clip; align_corners=True = pixel centres)."""
    _, _, h, w = disp.shape
    d = disp.clamp(-(r - 1), r - 1)
    ii = torch.arange(h, device=disp.device).view(1, h, 1).float()
    jj = torch.arange(w, device=disp.device).view(1, 1, w).float()
    return torch.stack([(jj + d[:, 1]) * (2.0 / (w - 1)) - 1.0,
                        (ii + d[:, 0]) * (2.0 / (h - 1)) - 1.0], dim=-1)


def grid_sample(img, grid):
    return torch.nn.functional.grid_sample(
        img, grid, mode="bilinear", padding_mode="border", align_corners=True)


def check_k1(dev, n=190, c=1, h=128, w=128, r=12, rows="B3"):
    """K1 at the flagship's final warp, (190, 1, 128, 128), R=12, by
    default; a second launch on the same inputs must give the same bits."""
    from cardiax_torch.ops import warp_kernels as wk
    gen = torch.Generator().manual_seed(1)
    img = smooth(gen, (n, c, h, w), 1.0, dev)
    disp = smooth(gen, (n, 2, h, w), 24.0, dev)
    clamped, clipped = clip_shares(disp, r)
    with torch.inference_mode():
        launch = lambda: wk._mc_warp_cuda(img, disp, r)  # noqa: E731
        out = launch()
        again = launch()
        ref = wk._mc_warp_plain(img, disp, r)
        torch.cuda.synchronize()
        require(torch.equal(out, again),
                f"K1 at {(n, c, h, w)}: two launches differ")
        err = (out - ref).abs().max().item()
        tol = 1e-5 * max(1.0, ref.abs().max().item())
        require(err <= tol, f"K1 disagrees with its plain version: {err} > {tol}")
        versus = same_as_baseline("K1", launch, out)
        grid = sample_grid(disp, r)
        lib = lambda: grid_sample(img, grid)  # noqa: E731
        lib_err = (lib() - ref).abs().max().item()
        t = times(launch, ["mc_warp_fwd_kernel"],
                  lambda: wk._mc_warp_plain(img, disp, r), lib)
    pix = n * h * w
    bound_ms, bound_by = bound((2 * c + 2) * pix * 4, (18 + 9 * c) * pix)
    print(f"K1 mc_warp_fwd ({n},{c},{h},{w}) R={r} [{rows}]: max|kernel-"
          f"plain| {err:.3e} (tol {tol:.1e}), repeat bit-identical, clamped "
          f"{clamped:.3%}, clipped {clipped:.3%}, "
          f"{time_text(t, bound_ms, bound_by, 'grid_sample')}"
          f" (max|grid_sample-plain| {lib_err:.2e}){versus}")
    return {"name": "mc_warp_fwd", "route": "cuda",
            "source": "cardiax_torch/csrc/mc_warp.cu",
            "replaces": "cardiax/ops/warp_pallas.py:350",
            "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by,
            **t}


def check_k1_ragged(dev):
    """K1 at C = 1, 2, 3 on frames whose width is no multiple of 4 (the
    scalar path) and on one that is (the float4 path), clamp and clip
    biting, two launches bit-identical."""
    from cardiax_torch.ops import warp_kernels as wk
    gen = torch.Generator().manual_seed(11)
    for n, c, h, w in ((6, 1, 40, 45), (5, 2, 17, 45), (4, 3, 33, 46),
                       (3, 3, 24, 20)):
        img = smooth(gen, (n, c, h, w), 1.0, dev)
        disp = smooth(gen, (n, 2, h, w), 15.0, dev)
        clip_shares(disp, 12)
        with torch.inference_mode():
            out = wk._mc_warp_cuda(img, disp, 12)
            again = wk._mc_warp_cuda(img, disp, 12)
            ref = wk._mc_warp_plain(img, disp, 12)
            torch.cuda.synchronize()
        require(torch.equal(out, again),
                f"K1 at {(n, c, h, w)}: two launches differ")
        err, tol = gate(f"K1 at {(n, c, h, w)}", (out,), (ref,))
        versus = same_as_baseline(
            "K1", lambda: wk._mc_warp_cuda(img, disp, 12), out)
        print(f"K1 ragged ({n},{c},{h},{w}) R=12: max|kernel-plain| "
              f"{err:.3e} (tol {tol:.1e}), repeat bit-identical{versus}")


def check_k2(dev, n=190, h=64, w=64):
    """K2 at the flagship's shooting grid, (190, 2, 64, 64), by default;
    dt 0.2, R=2."""
    from cardiax_torch.ops import epdiff_kernels as ek
    dt, r = 0.2, 2
    gen = torch.Generator().manual_seed(2)
    v = smooth(gen, (n, 2, h, w), 12.0, dev)     # |dt v| up to 2.4 px
    m = smooth(gen, (n, 2, h, w), 3.0, dev)
    u = smooth(gen, (n, 2, h, w), 2.0, dev)
    clamped = ((dt * v).abs() > r - 1).any(dim=1).float().mean().item()
    require(clamped > 0, "K2 check: the in-scan clamp does not bite")
    with torch.inference_mode():
        mk, uk = ek._epdiff_step_cuda(v, m, u, dt, r)
        mr, ur = ek._epdiff_step_plain(v, m, u, dt, r)
        torch.cuda.synchronize()
        err = max((mk - mr).abs().max().item(), (uk - ur).abs().max().item())
        tol = 1e-5 * max(1.0, mr.abs().max().item(), ur.abs().max().item())
        require(err <= tol, f"K2 disagrees with its plain version: {err} > {tol}")
        t = times(lambda: ek._epdiff_step_cuda(v, m, u, dt, r),
                  ["epdiff_step_fwd_kernel"],
                  lambda: ek._epdiff_step_plain(v, m, u, dt, r))
    pix = n * h * w
    bound_ms, bound_by = bound(10 * pix * 4, 80 * pix)
    print(f"K2 epdiff_step_fwd ({n},2,{h},{w}) dt=0.2 R=2: max|kernel-plain| "
          f"{err:.3e} (tol {tol:.1e}), clamped {clamped:.3%}, "
          f"{time_text(t, bound_ms, bound_by)}")
    return {"name": "epdiff_step_fwd", "route": "cuda",
            "source": "cardiax_torch/csrc/epdiff_step.cu",
            "replaces": "cardiax/ops/epdiff_pallas.py:157",
            "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by,
            **t}


def check_k4(dev, n=190, c=1, h=128, w=128, r=12, rows="B4"):
    """K4 at the flagship's final warp backward, (190, 1, 128, 128), R=12,
    by default; a second launch on the same inputs must give the same
    bits."""
    from cardiax_torch.ops import warp_kernels as wk
    gen = torch.Generator().manual_seed(4)
    img = smooth(gen, (n, c, h, w), 1.0, dev)
    disp = smooth(gen, (n, 2, h, w), 24.0, dev)
    g = torch.randn((n, c, h, w), generator=gen).to(dev)
    clamped, clipped = clip_shares(disp, r)
    launch = lambda: wk._mc_warp_disp_bwd_cuda(img, disp, g, r)  # noqa: E731
    out = launch()
    again = launch()
    ref = wk._mc_warp_disp_bwd_plain(img, disp, g, r)
    torch.cuda.synchronize()
    require(torch.equal(out, again),
            f"K4 at {(n, c, h, w)}: two launches differ")
    err = (out - ref).abs().max().item()
    tol = 1e-5 * max(1.0, ref.abs().max().item())
    require(err <= tol, f"K4 disagrees with its plain version: {err} > {tol}")
    versus = same_as_baseline("K4", launch, out)
    # yardstick: the grid gradient of grid_sample on the pre-clamped
    # displacement, image constant
    grid = sample_grid(disp, r).requires_grad_()
    warped = grid_sample(img, grid)
    lib = lambda: torch.autograd.grad(warped, grid, g,  # noqa: E731
                                      retain_graph=True)
    t = times(launch, ["mc_warp_disp_bwd_kernel"],
              lambda: wk._mc_warp_disp_bwd_plain(img, disp, g, r), lib)
    pix = n * h * w
    bound_ms, bound_by = bound((2 * c + 4) * pix * 4, (20 + 16 * c) * pix)
    print(f"K4 mc_warp_disp_bwd ({n},{c},{h},{w}) R={r} [{rows}]: max|kernel-"
          f"plain| {err:.3e} (tol {tol:.1e}), repeat bit-identical, clamped "
          f"{clamped:.3%}, clipped {clipped:.3%}, "
          f"{time_text(t, bound_ms, bound_by, 'grid_sample grid-grad')}"
          f"{versus}")
    return {"name": "mc_warp_disp_bwd", "route": "cuda",
            "source": "cardiax_torch/csrc/mc_warp.cu",
            "replaces": "cardiax/ops/warp_pallas.py:441",
            "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by,
            **t}


def k5_disp(kind, gen, n, h, w, r, scale, dev):
    """K5's displacements (n, 2, h, w): ``smooth`` (max |value| ``scale``);
    ``convergent``, every source pulled to its item's centre (the clamp at
    r - 1 then lands every source within r - 1 px of it on one coordinate:
    the longest lists of sources a tap); ``clip``, a smooth shift down and
    right of 0.3-0.9 (r - 1) px, so the clip holds whole rows and columns on
    the last row and column (a0 == a1); ``integer``, a smooth field rounded
    to whole pixels (every fraction 0)."""
    if kind == "smooth":
        return smooth(gen, (n, 2, h, w), scale, dev)
    if kind == "clip":
        d = smooth(gen, (n, 2, h, w), 0.3 * (r - 1), "cpu") + 0.6 * (r - 1)
        return d.contiguous().to(dev)
    if kind == "integer":
        return torch.round(smooth(gen, (n, 2, h, w), scale, dev))
    require(kind == "convergent", f"unknown K5 field {kind}")
    centre = torch.rand((n, 2, 1, 1), generator=gen) - 0.5
    ii = torch.arange(h).view(1, h, 1).float()
    jj = torch.arange(w).view(1, 1, w).float()
    d = torch.stack(torch.broadcast_tensors(
        (h - 1) / 2 + centre[:, 0] - ii, (w - 1) / 2 + centre[:, 1] - jj),
        dim=1)
    return d.contiguous().to(dev)


def check_k4_edges(dev):
    """K4 where its layout could break, R=12, against its plain version with
    two launches bit-identical: a width that is no multiple of 4 (the scalar
    path), C = 3 (the channel-sum order's two passes), more than 65,535
    items (the grid-z stride) and a shift that holds samples on the last row
    and column (the clip; sx = 0 there)."""
    from cardiax_torch.ops import warp_kernels as wk
    r = 12
    gen = torch.Generator().manual_seed(14)
    for kind, (n, c, h, w) in (("ragged", (6, 1, 40, 45)),
                               ("C=3", (4, 3, 33, 46)),
                               ("C=3 ragged", (2, 3, 30, 37)),
                               ("grid-z stride", (65600, 1, 8, 12)),
                               ("clip", (16, 1, 20, 12))):
        img = smooth(gen, (n, c, h, w), 1.0, dev)
        disp = k5_disp("clip" if kind == "clip" else "smooth", gen, n, h, w,
                       r, 15.0, dev)
        g = torch.randn((n, c, h, w), generator=gen).to(dev)
        if kind == "clip":      # samples held on the last row and column
            cy = (torch.arange(h, device=dev).view(1, h, 1)
                  + disp[:, 0].clamp(-(r - 1), r - 1))
            cx = (torch.arange(w, device=dev).view(1, 1, w)
                  + disp[:, 1].clamp(-(r - 1), r - 1))
            share = ((cy >= h - 1) & (cx >= w - 1)).float().mean().item()
            require(share > 0, "K4 clip case: no sample on the last row "
                               "and column")
            bite = f"last row and column {share:.3%}"
        else:
            bite = "clamped {:.3%}, clipped {:.3%}".format(
                *clip_shares(disp, r))

        def launch(img=img, disp=disp, g=g):
            return wk._mc_warp_disp_bwd_cuda(img, disp, g, r)
        out = launch()
        again = launch()
        ref = wk._mc_warp_disp_bwd_plain(img, disp, g, r)
        torch.cuda.synchronize()
        require(torch.equal(out, again),
                f"K4 {kind} at {(n, c, h, w)}: two launches differ")
        err, tol = gate(f"K4 {kind} at {(n, c, h, w)}", (out,), (ref,))
        versus = same_as_baseline("K4", launch, out)
        print(f"K4 {kind} ({n},{c},{h},{w}) R={r}: max|kernel-plain| "
              f"{err:.3e} (tol {tol:.1e}), repeat bit-identical, {bite}"
              f"{versus}")


def check_k5(dev, n, c, h, w, r, scale, rows, kind="smooth"):
    """K5 (both outputs) against its plain version at (n, c, h, w) with a
    ``kind`` displacement (``k5_disp``), its repeat bit-identical, and its
    times."""
    from cardiax_torch.ops import warp_kernels as wk
    gen = torch.Generator().manual_seed(5)
    img = smooth(gen, (n, c, h, w), 1.0, dev)
    disp = k5_disp(kind, gen, n, h, w, r, scale, dev)
    g = torch.randn((n, c, h, w), generator=gen).to(dev)
    shares = clip_shares(disp, r) if kind == "smooth" and scale > r - 1 \
        else None
    err, tol = gate_k5(f"K5 at {(n, c, h, w)} R={r} [{rows}]", img, disp,
                       g, r)
    # yardstick: grid_sample's gradients w.r.t. the input and the grid
    f = img.clone().requires_grad_()
    grid = sample_grid(disp, r).requires_grad_()
    warped = grid_sample(f, grid)
    lib = lambda: torch.autograd.grad(warped, (f, grid), g,  # noqa: E731
                                      retain_graph=True)
    t = times(lambda: wk._mc_warp_fused_bwd_cuda(img, disp, g, r),
              ["mc_warp_fused_bwd_kernel", "warp_band_kernel"],
              lambda: wk._mc_warp_fused_bwd_plain(img, disp, g, r), lib,
              plain_iters=5)
    pix = n * h * w
    # bytes: disp, field and g read, both outputs written; operations: the
    # scatter form's coordinates (~18 flops) and per channel K4's 16 plus
    # four weighted taps (8)
    bound_ms, bound_by = bound((3 * c + 4) * pix * 4, (38 + 24 * c) * pix)
    clamped = disp.abs().clamp(max=r - 1)
    band = [int(clamped[:, a].amax(dim=(1, 2)).max().item()) + 1
            for a in (0, 1)]
    bite = "" if shares is None else \
        f"clamped {shares[0]:.3%}, clipped {shares[1]:.3%}, "
    print(f"K5 mc_warp_fused_bwd ({n},{c},{h},{w}) R={r} {kind} max|disp| "
          f"{disp.abs().max().item():.2f} [{rows}]: max|kernel-plain| "
          f"{err:.3e} (tol {tol:.1e}), repeat bit-identical, {bite}"
          f"halo band {band[0]}x{band[1]} (of {r}), "
          f"{time_text(t, bound_ms, bound_by, 'grid_sample input+grid grad')}")
    return {"name": "mc_warp_fused_bwd", "route": "cuda",
            "source": "cardiax_torch/csrc/mc_warp.cu",
            "replaces": "cardiax/ops/warp_pallas.py:402",
            "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by,
            **t}


def gate_k5(what, img, disp, g, r):
    """K5 (both outputs) against its plain version (``gate``), after
    checking that a second launch on the same inputs gives the same bits."""
    from cardiax_torch.ops import warp_kernels as wk
    outs = wk._mc_warp_fused_bwd_cuda(img, disp, g, r)
    again = wk._mc_warp_fused_bwd_cuda(img, disp, g, r)
    refs = wk._mc_warp_fused_bwd_plain(img, disp, g, r)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(outs, again)),
            f"{what}: two launches on the same inputs differ")
    return gate(what, outs, refs)


def check_k5_all(dev):
    """K5 at the in-scan grid of 768x512 frames (B5's shape on the TPU),
    the ops path's ``expmap_svf`` (C=2, R=8), the flagship's final warp and
    768x512 frames (B10's), the clamp and clip biting; at the flagship's
    final warp with a trained model's displacement (max 1.9 px); then its
    hard cases: a convergent field, the clip holding whole rows, integer
    displacements, frames that are no multiple of the kernel's tile or
    narrower than a warp, and channel tails. Returns the entry at the
    flagship's warp."""
    check_k5(dev, 14, 2, 384, 256, 2, 3.0, "B5")
    check_k5(dev, 190, 2, 128, 128, 8, 18.0, "B5, expmap_svf")
    entry = check_k5(dev, 190, 1, 128, 128, 12, 24.0, "B7/B8")
    check_k5(dev, 14, 1, 768, 512, 12, 24.0, "B10")
    check_k5(dev, 190, 1, 128, 128, 12, 1.9, "B7/B8, trained-model band")
    check_k5(dev, 190, 1, 128, 128, 12, 0.0, "B7/B8, convergent",
             "convergent")
    cases = (("convergent", (16, 2, 128, 128), 12, 0.0),
             ("convergent", (6, 3, 40, 36), 8, 0.0),
             ("clip", (16, 2, 128, 128), 12, 0.0),
             ("clip", (4, 3, 20, 12), 12, 0.0),
             ("integer", (16, 2, 128, 128), 12, 18.0),
             ("integer", (6, 5, 40, 36), 8, 9.0),
             ("smooth", (6, 2, 40, 36), 12, 15.0),
             ("smooth", (4, 3, 20, 12), 12, 15.0),
             ("smooth", (3, 5, 17, 45), 2, 3.0))
    gen = torch.Generator().manual_seed(55)
    for kind, (n, c, h, w), r, scale in cases:
        img = smooth(gen, (n, c, h, w), 1.0, dev)
        disp = k5_disp(kind, gen, n, h, w, r, scale, dev)
        g = torch.randn((n, c, h, w), generator=gen).to(dev)
        err, tol = gate_k5(f"K5 {kind} at {(n, c, h, w)} R={r}", img,
                           disp, g, r)
        print(f"K5 hard case {kind} ({n},{c},{h},{w}) R={r}: max|kernel-"
              f"plain| {err:.3e} (tol {tol:.1e}), repeat bit-identical")
    return entry


def check_k3(dev, n=190, h=64, w=64, r=2, rows="B2", timed=True):
    """K3 at the flagship's shooting grid, (190, 2, 64, 64), dt 0.2, R=2,
    by default: the clamp biting (and, for R >= 2, the clip; at R = 1 the
    clamp at 0 leaves every sample on its own pixel), a second launch
    bit-identical to the first; its times unless not ``timed``."""
    from cardiax_torch.ops import epdiff_kernels as ek
    dt = 0.2
    gen = torch.Generator().manual_seed(3)
    # |dt v| up to R + 0.4 px
    v = smooth(gen, (n, 2, h, w), (r + 0.4) / dt, dev)
    m = smooth(gen, (n, 2, h, w), 3.0, dev)
    u = smooth(gen, (n, 2, h, w), 2.0, dev)
    gm = torch.randn((n, 2, h, w), generator=gen).to(dev)
    gu = torch.randn((n, 2, h, w), generator=gen).to(dev)
    clamped = ((dt * v).abs() > r - 1).any(dim=1).float().mean().item()
    ii = torch.arange(h, device=dev).view(1, h, 1).float()
    cy = ii + (-dt * v[:, 0]).clamp(-(r - 1), r - 1)
    clipped = ((cy < 0) | (cy > h - 1)).float().mean().item()
    require(clamped > 0 and (clipped > 0 or r == 1),
            f"K3 check at R={r}: clamp/clip do not bite")
    launch = lambda: ek._epdiff_step_bwd_cuda(  # noqa: E731
        v, m, u, gm, gu, dt, r)
    outs = launch()
    again = launch()
    refs = ek._epdiff_step_bwd_plain(v, m, u, gm, gu, dt, r)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(outs, again)),
            f"K3 at {(n, 2, h, w)} R={r}: two launches differ")
    err, tol = gate(f"K3 at {(n, 2, h, w)} R={r}", outs, refs)
    versus = same_as_baseline("K3", launch, outs)
    if not timed:
        print(f"K3 epdiff_step_bwd ({n},2,{h},{w}) dt=0.2 R={r} [{rows}]: "
              f"max|kernel-plain| {err:.3e} (tol {tol:.1e}), repeat "
              f"bit-identical, clamped {clamped:.3%}, clipped "
              f"{clipped:.3%}{versus}")
        return None
    # this tree's two kernels, and the baseline's
    t = times(launch, ["epdiff_step_bwd_tiled", "epdiff_step_bwd_chunked",
                       "epdiff_step_bwd_kernel"],
              lambda: ek._epdiff_step_bwd_plain(v, m, u, gm, gu, dt, r))
    pix = n * h * w
    bound_ms, bound_by = bound(16 * pix * 4, 160 * pix)
    print(f"K3 epdiff_step_bwd ({n},2,{h},{w}) dt=0.2 R={r} [{rows}]: "
          f"max|kernel-plain| {err:.3e} (tol {tol:.1e}), repeat "
          f"bit-identical, clamped {clamped:.3%}, clipped {clipped:.3%}, "
          f"{time_text(t, bound_ms, bound_by)}{versus}")
    return {"name": "epdiff_step_bwd", "route": "cuda",
            "source": "cardiax_torch/csrc/epdiff_step.cu",
            "replaces": "cardiax/ops/epdiff_pallas.py:192",
            "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by,
            **t}


def check_k3_all(dev):
    """K3 at the flagship's grid at R = 2 (the entry), 1 and 3 (a runtime
    radius), at the in-scan grid of 768x512 frames, at ragged shapes (the
    tile's edges, the 4x4 minimum, a 45-px width) and at large runtime
    radii (sources over several chunks; a radius beyond the plane)."""
    entry = check_k3(dev)
    check_k3(dev, r=1, rows="B2, R=1")
    check_k3(dev, r=3, rows="B2, R=3 (runtime radius)")
    check_k3(dev, 14, 384, 256, rows="B2, 768x512 frames")
    for n, h, w, r in ((5, 24, 20, 2), (3, 17, 45, 3), (2, 4, 4, 2),
                       (1, 40, 36, 1), (4, 20, 12, 6)):
        check_k3(dev, n, h, w, r, rows="ragged", timed=False)
    for n, h, w, r in ((4, 64, 64, 18), (2, 64, 64, 40), (2, 20, 12, 70)):
        check_k3(dev, n, h, w, r, rows="large radius", timed=False)
    return entry


# the flagship's fluid metric on its 64^2 shooting grid: configs/joint.json's
# alpha 2 over shoot_downsample^2 = 4, gamma 1, power 2
SOLVE_METRIC = (0.5, 1.0, 2)


def solve_fields(seed, n, h, w, dt, r, dev):
    """(m, u, gm', gu', v) for K6/K7 with v = K m: the in-scan clamp biting
    and, on the border rows, the clip (at R = 1 the clamp at 0 leaves every
    sample on its own pixel). The mask and tap tests of K7 are
    discontinuous at integer values of b = -dt v, and the kernel's v
    differs from the plain version's (cuBLAS, another summation order) by
    ~1e-6, so b is drawn at least 0.2 px from every integer (a smooth field
    with each unit interval squeezed into its middle 60%) and m = L v is
    solved for it in float64; then no mask or tap can flip between the two."""
    from cardiax_torch.ops import epdiff_kernels as ek
    from cardiax_torch.ops.fluid_metric import _helmholtz_mm_weights
    gen = torch.Generator().manual_seed(seed)
    b = smooth(gen, (n, 2, h, w), 2.4, "cpu").double()
    b = torch.floor(b) + 0.2 + 0.6 * (b - torch.floor(b))
    ty, tx, spec = (torch.from_numpy(a).double() for a in
                    _helmholtz_mm_weights(h, w, *SOLVE_METRIC, False))
    m = ty.T @ ((ty @ (-b / dt) @ tx.T) * spec) @ tx
    m = m.float().contiguous().to(dev)
    u = smooth(gen, (n, 2, h, w), 2.0, dev)
    gm = torch.randn((n, 2, h, w), generator=gen).to(dev)
    gu = torch.randn((n, 2, h, w), generator=gen).to(dev)
    ops = ek._solve_operands(h, w, *SOLVE_METRIC, dev)
    v = ek._solve_plain(m, *ops)
    bk = -dt * v
    margin = (bk - torch.round(bk)).abs().min().item()
    require(margin > 0.1, f"K6/K7 fields: b within {margin} of an integer")
    clamped = (bk.abs() > r - 1).any(dim=1).float().mean().item()
    ii = torch.arange(h, device=dev).view(1, h, 1).float()
    cy = ii + bk[:, 0].clamp(-(r - 1), r - 1)
    clipped = ((cy < 0) | (cy > h - 1)).float().mean().item()
    require(clamped > 0 and (clipped > 0 or r == 1),
            f"K6/K7 fields at {(n, 2, h, w)}: clamp/clip do not bite")
    return (m, u, gm, gu, v), ops, (clamped, clipped, margin)


def gate(what, outs, refs):
    """Max |kernel - plain| against 1e-5 of the plain outputs' range; on a
    failure, the count of elements over the tolerance."""
    err = max((o - f).abs().max().item() for o, f in zip(outs, refs))
    tol = 1e-5 * max([1.0] + [f.abs().max().item() for f in refs])
    if err > tol:
        over = sum(int(((o - f).abs() > tol).sum().item())
                   for o, f in zip(outs, refs))
        raise RuntimeError(f"{what} disagrees with its plain version: {err} "
                           f"> {tol} at {over} elements")
    return err, tol


def solve_turn(bwd, m, u, ops, gm, gu, dt, r, scratch):
    """One K6 launch (K7 with ``bwd``) through its C entry with a workspace
    of 3 (K7: 5) planes an item: the earlier design's kernels (PR 4-7) need
    it and this tree's ignore it, so ``--baseline`` times both by one call."""
    from cardiax_torch.ops import epdiff_kernels as ek
    name = "epdiff_step_solve_bwd" if bwd else "epdiff_step_solve_fwd"
    fn = ek._solve_fn(name, 10 if bwd else 8)
    n, _, h, w = m.shape
    outs = (torch.empty_like(m), torch.empty_like(u))
    ins = (m, u, *ops) + ((gm, gu) if bwd else ())
    err = fn(*(t.data_ptr() for t in ins + outs), scratch.data_ptr(), n, h,
             w, float(dt), int(r), torch.cuda.current_stream().cuda_stream)
    ek.check(err, name)
    return outs


def solve_bounds(n, h, w, solves, stencil_flops, planes):
    """K6/K7's bounds: (bound_ms, bound_by) with the solve's products on
    the tensor cores in 3xTF32, the rest in f32, and the bound of PR 4-7
    with every flop on the f32 CUDA cores. A solve is four products, 4 H W
    (H + W) flops a plane; ``planes`` f32 planes are read or written."""
    pix = n * h * w
    mm = solves * 4 * pix * (h + w)
    return (bound(planes * pix * 4, stencil_flops * pix, mm),
            bound(planes * pix * 4, stencil_flops * pix + mm))


def check_k6(dev, n=190, h=64, w=64, timed=True):
    """K6 at the flagship's shooting grid, (190, 2, 64, 64), by default;
    dt 0.2, R=2, the flagship's metric on that grid; a second launch
    bit-identical to the first; its times unless not ``timed``."""
    from cardiax_torch.ops import epdiff_kernels as ek
    from cardiax_torch.ops.fluid_metric import sharp
    dt, r = 0.2, 2
    (m, u, _, _, _), ops, (clamped, clipped, margin) = solve_fields(
        60, n, h, w, dt, r, dev)
    shape = f"({n},2,{h},{w}) dt=0.2 R={r}"
    launch = lambda: ek._epdiff_step_solve_cuda(  # noqa: E731
        m, u, *ops, dt, r)
    with torch.inference_mode():
        outs, again = launch(), launch()
        refs = ek._epdiff_step_solve_plain(m, u, *ops, dt, r)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(outs, again)),
                f"K6 at {shape}: two launches differ")
        err, tol = gate(f"K6 at {shape}", outs, refs)
        head = (f"K6 epdiff_step_solve_fwd {shape} [B11]: max|kernel-plain| "
                f"{err:.3e} (tol {tol:.1e}), repeat bit-identical, clamped "
                f"{clamped:.3%}, clipped {clipped:.3%}, b >= {margin:.2f} px "
                f"from an integer")
        if not timed:
            print(head)
            return None
        scratch = torch.empty((n, 3, h, w), device=dev) if BASELINE else None
        t = times(launch, ["epdiff_step_solve_fwd_kernel"],
                  lambda: ek._epdiff_step_solve_plain(m, u, *ops, dt, r),
                  turn_fn=lambda: solve_turn(False, m, u, ops, None, None,
                                             dt, r, scratch))
        pair = lambda: ek._epdiff_step_cuda(  # noqa: E731
            sharp(m, *SOLVE_METRIC), m, u, dt, r)
        pair_ms, pair_kernel_ms = time_ms(pair), device_ms(pair)
    (bound_ms, bound_by), (core_ms, core_by) = solve_bounds(n, h, w, 2, 90, 8)
    print(f"{head}, {time_text(t, bound_ms, bound_by)}; bound on the f32 "
          f"CUDA cores {core_ms:.4f} ms ({core_by}); unfused pair sharp + K2 "
          f"{pair_ms:.4f} ms (kernels alone {fmt_ms(pair_kernel_ms)})")
    return {"name": "epdiff_step_solve_fwd", "route": "cuda",
            "source": "cardiax_torch/csrc/epdiff_step.cu",
            "replaces": "cardiax/ops/epdiff_pallas.py:298",
            "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_cuda_core_ms": core_ms, **t, "unfused_pair_ms": pair_ms,
            "unfused_pair_kernel_ms": pair_kernel_ms}


def check_k7(dev, n=190, h=64, w=64, r=2, timed=True):
    """K7 at the flagship's shooting grid, (190, 2, 64, 64), dt 0.2, R=2,
    by default; a second launch bit-identical to the first; its times
    unless not ``timed``."""
    from cardiax_torch.ops import epdiff_kernels as ek
    from cardiax_torch.ops.fluid_metric import sharp
    dt = 0.2
    (m, u, gm, gu, v), ops, (clamped, clipped, margin) = solve_fields(
        68 + r, n, h, w, dt, r, dev)
    shape = f"({n},2,{h},{w}) dt=0.2 R={r}"
    launch = lambda: ek._epdiff_step_solve_bwd_cuda(  # noqa: E731
        m, u, *ops, gm, gu, dt, r)
    outs, again = launch(), launch()
    refs = ek._epdiff_step_solve_bwd_plain(m, u, *ops, gm, gu, dt, r)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(outs, again)),
            f"K7 at {shape}: two launches differ")
    err, tol = gate(f"K7 at {shape}", outs, refs)
    head = (f"K7 epdiff_step_solve_bwd {shape} [B12]: max|kernel-plain| "
            f"{err:.3e} (tol {tol:.1e}), repeat bit-identical, clamped "
            f"{clamped:.3%}, clipped {clipped:.3%}, b >= {margin:.2f} px "
            f"from an integer")
    if not timed:
        print(head)
        return None

    def pair():
        """the separate solve's backward: K3 on the saved v, then g_m +=
        K g_v"""
        g_v, g_m, g_u = ek._epdiff_step_bwd_cuda(v, m, u, gm, gu, dt, r)
        return g_m + sharp(g_v, *SOLVE_METRIC), g_u

    scratch = torch.empty((n, 5, h, w), device=dev) if BASELINE else None
    t = times(launch, ["epdiff_step_solve_bwd_kernel"],
              lambda: ek._epdiff_step_solve_bwd_plain(m, u, *ops, gm, gu,
                                                      dt, r),
              turn_fn=lambda: solve_turn(True, m, u, ops, gm, gu, dt, r,
                                         scratch))
    pair_ms, pair_kernel_ms = time_ms(pair), device_ms(pair)
    (bound_ms, bound_by), (core_ms, core_by) = solve_bounds(n, h, w, 4, 160,
                                                            12)
    print(f"{head}, {time_text(t, bound_ms, bound_by)}; bound on the f32 "
          f"CUDA cores {core_ms:.4f} ms ({core_by}); unfused pair K3 + "
          f"sharp(g_v) + add {pair_ms:.4f} ms (kernels alone "
          f"{fmt_ms(pair_kernel_ms)})")
    return {"name": "epdiff_step_solve_bwd", "route": "cuda",
            "source": "cardiax_torch/csrc/epdiff_step.cu",
            "replaces": "cardiax/ops/epdiff_pallas.py:336",
            "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_cuda_core_ms": core_ms, **t, "unfused_pair_ms": pair_ms,
            "unfused_pair_kernel_ms": pair_kernel_ms}


def check_solve_all(dev):
    """K6 and K7 at the flagship's grid (the entries) and at 128^2 items,
    timed; at a ragged shape (52 rows: a cluster of 4 bands, the last of 4
    rows; widths no multiple of 8) and at N = 1; K7 also at R = 1, at a
    runtime radius (3) and at the 4x4 minimum."""
    entries = [check_k6(dev), check_k7(dev)]
    check_k6(dev, 190, 128, 128)      # the largest item the fused solve takes
    check_k7(dev, 190, 128, 128)
    for n, h, w in ((7, 52, 36), (1, 64, 64)):
        check_k6(dev, n, h, w, timed=False)
        check_k7(dev, n, h, w, timed=False)
    for n, h, w, r in ((3, 24, 20, 1), (3, 24, 20, 3), (2, 4, 4, 2)):
        check_k7(dev, n, h, w, r, timed=False)
    return entries


def random_nets(cfg, n_pairs, seed: int, frame_size=None):
    """The configured networks with seeded random weights. JAX
    zero-initialises every momentum head (every warp would be the
    identity); small random weights there make the shooting and the warps
    real."""
    from cardiax_torch.models import build_model, init_weights
    from cardiax_torch.models.unet import MomentumUNet
    gen = torch.Generator().manual_seed(seed)
    nets = {name: build_model(mc, n_pairs=n_pairs, frame_size=frame_size)
            for name, mc in cfg["networks"].items()}
    for b in nets.values():
        init_weights(b.module, gen)
        b.initialized = True
    heads = [m.head for b in nets.values() for m in b.module.modules()
             if isinstance(m, MomentumUNet)]
    with torch.no_grad():
        for head in heads:
            head.weight.copy_(torch.randn(head.weight.shape, generator=gen)
                              * 0.05)
    return nets


def n_euler_steps(cfg) -> int:
    """The Euler steps of the configured registration network."""
    return next(int(mc["n_integration_steps"])
                for mc in cfg["networks"].values()
                if "n_integration_steps" in mc)


def counts():
    """(K2, K3, K1, K4, K5, K6, K7) launches so far."""
    from cardiax_torch.ops import counters
    c = counters.launches
    return tuple(c[k] for k in ("epdiff_step_fwd", "epdiff_step_bwd",
                                "mc_warp_fwd", "mc_warp_disp_bwd",
                                "mc_warp_fused_bwd", "epdiff_step_solve_fwd",
                                "epdiff_step_solve_bwd"))


def zero_counts():
    from cardiax_torch.ops import counters
    counters.reset()


def named_counts():
    from cardiax_torch.ops import counters
    return counters.snapshot()


@contextlib.contextmanager
def plain_path(sh, ek, wk):
    """The shooting and every banded warp through the plain versions
    (autograd of the plain forwards), so no kernel launches."""
    saved = sh.epdiff_step, sh.epdiff_step_solve, wk.mc_warp_fwd_op

    def step_solve_plain(m, u, dt, radius, alpha, gamma, power):
        ops = ek._solve_operands(*m.shape[-2:], alpha, gamma, power,
                                 m.device)
        return ek._epdiff_step_solve_plain(m, u, *ops, dt, radius)

    before = counts()
    try:
        sh.epdiff_step = ek._epdiff_step_plain
        sh.epdiff_step_solve = step_solve_plain
        wk.mc_warp_fwd_op = wk._mc_warp_plain
        yield
    finally:
        sh.epdiff_step, sh.epdiff_step_solve, wk.mc_warp_fwd_op = saved
    torch.cuda.synchronize()
    require(counts() == before, "the plain run launched a kernel")


def build_slice(seed: int = 0):
    """The flagship at full width with seeded random weights, the engine on
    the card, and a 15-slice synthetic test set (batches of 10 and 5+5)."""
    from cardiax_torch.data.datasets import JointDataset
    from cardiax_torch.data.synthetic import make_dataset
    from cardiax_torch.train import build_trainer
    cfg = json.loads((ROOT / "configs" / "joint.json").read_text())
    ds_cfg = cfg["datasets"]["test"]
    t_myo = int(ds_cfg["n_myo_frames_to_use_for_regression"])
    nets = random_nets(cfg, t_myo - 1, seed)
    data = make_dataset(n_subjects=5, slices_per_subject=3, h=128, w=128,
                        n_frames=t_myo, seed=seed)
    dataset = JointDataset(data, dataset_config=ds_cfg)
    engine = build_trainer(cfg["training"], None, cfg)
    engine.setup(nets, None, 1)
    return cfg, engine, dataset


def run_slice(profile_dir):
    from cardiax_torch.ops import epdiff_kernels as ek
    from cardiax_torch.ops import shooting as sh
    from cardiax_torch.ops import warp_kernels as wk
    cfg, engine, dataset = build_slice()
    n_steps = int(cfg["networks"]["joint_register_strainmat"]
                  ["n_integration_steps"])
    batch_size = int(cfg["training"]["batch_size"])
    # --- the main path: counts from 0 around engine.test only -------------
    zero_counts()
    preds, perf, _ = engine.test({}, {"test": dataset})
    torch.cuda.synchronize()
    launches = named_counts()
    require(sum(launches.values()) == launches["epdiff_step_fwd"]
            + launches["mc_warp_fwd"],
            f"engine.test launched a kernel other than K1, K2: {launches}")
    n_batches = math.ceil(len(dataset) / batch_size)
    require(n_batches >= 2 and len(dataset) % batch_size != 0,
            "the slice must run >= 2 batches, the last one padded")
    require(len(preds) == len(dataset), "padded items leaked into preds")
    require(launches["epdiff_step_fwd"] == n_steps * n_batches,
            f"K2 launches {launches['epdiff_step_fwd']} != "
            f"{n_steps} x {n_batches} batches")
    require(launches["mc_warp_fwd"] == n_batches,
            f"K1 launches {launches['mc_warp_fwd']} != {n_batches} batches")
    losses = {k: v for k, v in perf.items() if "/loss_" in k}
    require(all(math.isfinite(v) for v in perf.values()),
            f"non-finite metric: {perf}")
    for p in preds:
        for k in ("strain_matrix_pred", "TOS_pred", "deformed_source_pred"):
            require(bool(torch.isfinite(torch.from_numpy(p[k])).all()),
                    f"non-finite {k}")
    u = torch.stack([torch.from_numpy(p["displacement_pred"]) for p in preds])
    radius = int(cfg["networks"]["joint_register_strainmat"]
                 .get("final_warp_radius", 12))
    clamped = (u.abs() > radius - 1).any(dim=2).float().mean().item()
    require(u.abs().max().item() > 0.05, "the momentum head moved nothing")
    print(f"slice: engine.test over {n_batches} batches ({len(dataset)} slices"
          f", last batch padded) at batch {batch_size}, 128^2, T=20, Ts=40, "
          f"S=126, {n_steps} steps: launches {launches}, max|u_inv| "
          f"{u.abs().max().item():.3f} px, final-warp clamp share "
          f"{clamped:.4%}, total_loss {losses['final-test/loss_total_loss']:.6g}, "
          f"LMA_auc {perf.get('final-test/LMA_auc', float('nan')):.4f}")

    # --- the same eval step through the plain versions on the card --------
    batch = next(iter(engine.scheme.make_loader(dataset, batch_size, False)))
    arrays = engine.to_device(batch)
    values_k, preds_k = engine.eval_step(arrays)
    with plain_path(sh, ek, wk):
        values_p, preds_p = engine.eval_step(arrays)
    diffs = {}
    for k in ("strain_matrix", "TOS"):
        ref = preds_p[k].float()
        diffs[k] = (preds_k[k].float() - ref).abs().max().item()
        require(diffs[k] <= 2e-2 * max(1.0, ref.abs().max().item()),
                f"{k}: kernel path vs plain path differ by {diffs[k]}")
    tl_k = values_k["total_loss"].item()
    tl_p = values_p["total_loss"].item()
    diffs["total_loss"] = abs(tl_k - tl_p)
    require(diffs["total_loss"] <= 1e-3 * max(1.0, abs(tl_p)),
            f"total_loss: kernel path {tl_k} vs plain path {tl_p}")

    # --- eval step time ----------------------------------------------------
    for _ in range(2):
        engine.eval_step(arrays)
    torch.cuda.synchronize()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.eval_step(arrays)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"plain-vs-kernel eval step: max|d| strain_matrix "
          f"{diffs['strain_matrix']:.3e}, TOS {diffs['TOS']:.3e}, total_loss "
          f"{diffs['total_loss']:.3e} (of {tl_p:.6g}); eval step {step_ms:.3f} ms/batch of "
          f"{batch_size} slices = {batch_size / step_ms * 1e3:.1f} slices/s")
    if profile_dir:
        busy_ms, prof = profile_steps(lambda: engine.eval_step(arrays))
        print(f"eval step: {busy_line(busy_ms, step_ms)}"
              f"{busy_turns(lambda: engine.eval_step(arrays))}")
        write_profile(prof, Path(profile_dir), "eval")
    return launches


def profile_steps(step, reps: int = 3):
    """Profile ``reps`` calls of ``step`` after one warm-up call. Returns
    the device time per call, the union of the intervals of the CUDA
    kernels, copies and sets (or None if the trace holds no device events),
    and the profile. GPU-side spans of annotations (``Optimizer.step``,
    ``record_function``) are not device work: in eager mode such a span
    also covers the host's gaps between its kernels."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    busy = device_union_ms(prof)
    return (None if busy is None else busy / reps), prof


def device_union_ms(prof, annotations: bool = False):
    """The union of the device events' intervals in ``prof`` (ms), the
    GPU-side annotation spans left out unless ``annotations``; None
    without device events."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and (annotations
                        or not getattr(e, "is_user_annotation", False)))
    if not spans:
        return None
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    busy += hi - lo
    return busy / 1e3


def busy_turns(step) -> str:
    """With ``--baseline``: the step's device time in turns baseline, this
    tree, this tree, baseline (``profile_steps`` each)."""
    if not BASELINE:
        return ""
    turns = []
    for base in (True, False, False, True):
        with baseline_kernels(base):
            turns.append(profile_steps(step)[0])
    return ("; device busy a step in turns baseline, this, this, baseline: "
            + ", ".join(fmt_ms(t) for t in turns))


def busy_line(busy_ms, step_ms: float) -> str:
    """The device-busy line of a profiled step against its host time."""
    if busy_ms is None:
        return "device busy not measured (no device events in the trace)"
    return (f"device busy {busy_ms:.3f} ms a step from the profiler over 3 "
            f"steps ({1 - busy_ms / step_ms:.1%} idle)")


def write_profile(prof, out_dir: Path, kind: str, calls: str = "") -> None:
    """The profiler table of 3 ``kind`` steps (or ``calls``), to
    ``out_dir``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    path = out_dir / f"{kind}_profile.txt"
    path.write_text(f"{torch.cuda.get_device_name(0)}; "
                    f"{calls or f'3 {kind} steps'}\n{table}\n")
    print(f"profile: {path}")


def set_fields(cfg, changes) -> None:
    """``changes`` maps dotted config paths to new values."""
    for key, val in changes.items():
        node = cfg
        *path, leaf = key.split(".")
        for seg in path:
            node = node[seg]
        node[leaf] = val


@contextlib.contextmanager
def watched_main_run():
    """Around ``main.run``: the warnings it raised (``caught``), each
    checkpoint save's host time and file size (``saves``), the training
    state right after a resume restored it (``restored``), each engine
    that trained with the loaders it trained on (``engines``: (engine,
    train loader, val loader)), the parameters each engine's set-up drew
    (``initial``) and how many batches a ``PrefetchBatcher`` carried to the
    card (``prefetched``)."""
    from cardiax_torch.data.prefetch import PrefetchBatcher
    from cardiax_torch.io.checkpoints import CheckpointManager, to_cpu
    from cardiax_torch.train.engine import TrainerEngine
    saves, restored, engines, initial = [], [], [], []
    prefetched = [0]
    save, load = CheckpointManager.save, TrainerEngine._load_training_state
    cache, setup = TrainerEngine._maybe_device_cache, TrainerEngine.setup
    to_device = PrefetchBatcher._to_device

    def recorded_setup(self, *args, **kwargs):
        setup(self, *args, **kwargs)
        initial.append({n: {k: v.detach().cpu().clone()
                            for k, v in m.state_dict().items()}
                        for n, m in self.modules.items()})

    def counted_to_device(self, batch, stream):
        prefetched[0] += 1
        return to_device(self, batch, stream)

    def timed_save(self, epoch, *args, **kwargs):
        t0 = time.perf_counter()
        wrote = save(self, epoch, *args, **kwargs)
        if wrote:
            # the save's own time; its file is written on the writer thread
            took = time.perf_counter() - t0
            self.wait()
            saves.append((took, self._path(epoch).stat().st_size))
        return wrote

    def recorded_load(self, state):
        load(self, state)
        restored.append({
            "params": {n: {k: v.detach().cpu().clone()
                           for k, v in m.state_dict().items()}
                       for n, m in self.modules.items()},
            "opt_states": to_cpu(self._optimizer_states())})

    def recorded_cache(self, loader, cfg, tag):
        out = cache(self, loader, cfg, tag)
        if tag == "train":
            engines.append([self, out, None])
        elif engines and engines[-1][0] is self:
            engines[-1][2] = out
        return out

    CheckpointManager.save, TrainerEngine._load_training_state = \
        timed_save, recorded_load
    TrainerEngine._maybe_device_cache = recorded_cache
    TrainerEngine.setup = recorded_setup
    PrefetchBatcher._to_device = counted_to_device
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            watch = types.SimpleNamespace(
                caught=caught, saves=saves, restored=restored,
                engines=engines, initial=initial, prefetched=0)
            yield watch
    finally:
        CheckpointManager.save, TrainerEngine._load_training_state = \
            save, load
        TrainerEngine._maybe_device_cache = cache
        TrainerEngine.setup = setup
        PrefetchBatcher._to_device = to_device
        watch.prefetched = prefetched[0]


def dispatch_text(watch, label, pipelined: bool) -> str:
    """Gate the one engine of a ``main.run`` on JAX's ``auto`` engagement
    for a cacheable dataset: both datasets resident on the card, train and
    val fused, one combined train+val pass, pipelined as given (JAX
    pipelines only without checkpoints), every fused step a CUDA graph.
    Returns the summary text."""
    from cardiax_torch.data.loader import DeviceBatcher
    require(len(watch.engines) == 1,
            f"{label}: {len(watch.engines)} engines trained")
    eng, train_loader, val_loader = watch.engines[0]
    got = (isinstance(train_loader, DeviceBatcher),
           isinstance(val_loader, DeviceBatcher), eng.last_fuse_engaged,
           eng.last_fuse_trainval, eng.last_pipeline_engaged)
    want = (True, True, (True, True), True, pipelined)
    require(got == want,
            f"{label}: (train resident, val resident, fused, train+val, "
            f"pipelined) = {got}, not JAX's {want}")
    graphs = [r.graph for r in eng._runners.values()]
    require(graphs and all(g.graph is not None for g in graphs),
            f"{label}: a fused step was not captured")
    return (f"dispatch as JAX's auto: datasets resident, fused train and "
            f"val, combined train+val, {'' if pipelined else 'not '}"
            f"pipelined; {len(graphs)} CUDA graphs captured, "
            f"{sum(g.replays for g in graphs)} replays")


def figure_text(run_dir: Path, caught, expected: int) -> str:
    """How many periodic figures ``run_dir/figures`` holds, or why none
    were drawn. The card's machine may lack matplotlib: a figure that fails
    warns once and training goes on, as in JAX."""
    figs = sorted((run_dir / "figures").glob("epoch_*.png")) \
        if (run_dir / "figures").is_dir() else []
    failed = [str(w.message) for w in caught
              if "periodic visualization failed" in str(w.message)]
    require(len(figs) == expected or (failed and not figs),
            f"{len(figs)} figures in {run_dir} (expected {expected}) and "
            f"no warning")
    if figs:
        return f"{len(figs)} periodic figures written"
    return f"figures skipped: {failed[0]}"


def save_text(saves) -> str:
    if not saves:
        return "no checkpoint saved"
    ms = [t * 1e3 for t, _ in saves]
    return (f"{len(saves)} checkpoint saves, host time {', '.join(f'{x:.3f}' for x in ms)} "
            f"ms, {saves[-1][1] / 1e6:.3f} MB each")


def run_train(tmp: Path, label: str = "train"):
    """``cardiax_torch.main.run`` on configs/joint.json at full width, with
    only its data, split, epochs and saving_dir changed; launch counts from
    0 around it. With ``shooting._FUSED_SOLVE`` set, the Euler steps take
    K6/K7 instead of K2/K3. Returns the launches, the config and the
    result."""
    from cardiax_torch import main as port_main
    from cardiax_torch.data.synthetic import make_dataset, save_npy
    from cardiax_torch.io.checkpoints import CheckpointManager
    from cardiax_torch.ops import shooting as sh
    cfg = json.loads((ROOT / "configs" / "joint.json").read_text())
    t_myo = int(cfg["datasets"]["train"]["n_myo_frames_to_use_for_regression"])
    npy = tmp / "slices.npy"
    save_npy(str(npy), make_dataset(n_subjects=7, slices_per_subject=5,
                                    h=128, w=128, n_frames=t_myo, seed=5))
    changes = {
        "training.epochs": 2,
        "saving.saving_dir": str(tmp / "run"),
        "data.npy_filename": str(npy),
        "data_split": {"method": "by_count", "splits": {
            "train": {"count": 25}, "val": {"count": 5},
            "test": {"count": 5}}},
    }
    set_fields(cfg, changes)
    print(f"{label}: configs/joint.json with {json.dumps(changes)}")
    epochs = changes["training.epochs"]
    batch_size = int(cfg["training"]["batch_size"])
    n_steps = n_euler_steps(cfg)
    vis_every = max(1, int(float(cfg["others"]["wandb_visualize_interval"])
                           * epochs))
    n_figs = len(range(0, epochs, vis_every))
    zero_counts()
    t0 = time.perf_counter()
    with watched_main_run() as watch:
        res = port_main.run(copy.deepcopy(cfg))
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = named_counts()
    train_steps = epochs * math.ceil(25 / batch_size)
    # validation every epoch, each figure's val batch, then the final val
    # and test evaluations
    eval_batches = epochs + n_figs + 2
    fwd, bwd = n_steps * (train_steps + eval_batches), n_steps * train_steps
    solve = bool(sh._FUSED_SOLVE)
    expect = {"mc_warp_fwd": train_steps + eval_batches,
              "epdiff_step_fwd": 0 if solve else fwd,
              "epdiff_step_bwd": 0 if solve else bwd,
              "mc_warp_disp_bwd": train_steps, "mc_warp_fused_bwd": 0,
              "epdiff_step_solve_fwd": fwd if solve else 0,
              "epdiff_step_solve_bwd": bwd if solve else 0}
    require(launches == expect, f"{label} launches {launches} != {expect}")
    hist = res["train_loss_dict"]
    for key in ("train/total_loss", "val/total_loss"):
        require(len(hist[key]) == epochs
                and all(math.isfinite(v) for v in hist[key]),
                f"{label} {key} per epoch: {hist[key]}")
    perf = {k: v for t in ("val", "test")
            for k, v in res[f"{t}_performance"].items()}
    require(all(math.isfinite(v) for v in perf.values()),
            f"{label}: non-finite metric: {perf}")
    run_dir = tmp / "run"
    require((run_dir / "model-joint_register_strainmat.pt").is_file(),
            f"{label}: the trained model was not saved")
    keep = int(cfg["saving"]["save_model_num"])
    saved = CheckpointManager(run_dir / "checkpoints").epochs()
    require(saved == list(range(max(0, epochs - keep), epochs))
            and len(watch.saves) == epochs,
            f"{label}: checkpoints of epochs {saved}, {len(watch.saves)} "
            f"saves")
    print(f"{label}: main.run {epochs} epochs x {train_steps // epochs} train "
          f"steps (last batch padded) + {eval_batches} eval batches in "
          f"{secs:.2f} s; total_loss per epoch train "
          f"{[round(v, 6) for v in hist['train/total_loss']]}, val "
          f"{[round(v, 6) for v in hist['val/total_loss']]}; checkpoints of "
          f"epochs {saved} ({save_text(watch.saves)}); "
          f"{figure_text(run_dir, watch.caught, n_figs)}; launches "
          f"{launches}; {dispatch_text(watch, label, pipelined=False)}")
    return launches, cfg, res


def run_resume(cfg):
    """Resume the train phase's run (``cfg``) to one more epoch, then
    evaluate its saved models alone (``inference_only``); launch counts from
    0 around each. Returns the resumed run's result."""
    from cardiax_torch import main as port_main
    from cardiax_torch.io.checkpoints import CheckpointManager
    run_dir = Path(cfg["saving"]["saving_dir"])
    mgr = CheckpointManager(run_dir / "checkpoints")
    start = mgr.latest_epoch() + 1
    saved = mgr.restore()
    cfg = copy.deepcopy(cfg)
    set_fields(cfg, {"training.epochs": start + 1, "training.resume": True})
    epochs = start + 1
    batch_size = int(cfg["training"]["batch_size"])
    n_steps = n_euler_steps(cfg)
    vis_every = max(1, int(float(cfg["others"]["wandb_visualize_interval"])
                           * epochs))
    n_figs = int(start % vis_every == 0)
    zero_counts()
    t0 = time.perf_counter()
    with watched_main_run() as watch:
        res = port_main.run(copy.deepcopy(cfg))
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = named_counts()
    require(len(watch.restored) == 1, "resume: the state was not restored")
    got = watch.restored[0]
    for name, state in saved["params"].items():
        for k, v in state.items():
            require(torch.equal(got["params"][name][k], v),
                    f"resume: restored {name}.{k} differs from the file")
    n_opt = 0
    for name, st in saved["opt_states"].items():
        for part in ("optimizer", "schedule"):
            want, have = st[part], got["opt_states"][name][part]
            if part == "optimizer":
                for idx, slots in want["state"].items():
                    for k, v in slots.items():
                        require(torch.equal(have["state"][idx][k], v),
                                f"resume: {name} optimizer {idx}.{k} differs")
                        n_opt += 1
                require(have["param_groups"] == want["param_groups"],
                        f"resume: {name} param groups differ")
            else:
                require(have == want, f"resume: {name} schedule differs")
    steps = math.ceil(25 / batch_size)
    eval_batches = 1 + n_figs + 2
    expect = {"mc_warp_fwd": steps + eval_batches,
              "epdiff_step_fwd": n_steps * (steps + eval_batches),
              "epdiff_step_bwd": n_steps * steps,
              "mc_warp_disp_bwd": steps, "mc_warp_fused_bwd": 0,
              "epdiff_step_solve_fwd": 0, "epdiff_step_solve_bwd": 0}
    require(launches == expect, f"resume launches {launches} != {expect}")
    hist = res["train_loss_dict"]
    for key in ("train/total_loss", "val/total_loss"):
        require(len(hist[key]) == 1 and math.isfinite(hist[key][0]),
                f"resume {key}: {hist[key]}")
    require(mgr.latest_epoch() == start
            and mgr.restore()["extra"]["epoch"] == start,
            f"resume: no checkpoint of epoch {start}")
    print(f"resume: training.resume with training.epochs {epochs}: started "
          f"at epoch {start}, restored {sum(len(s) for s in saved['params'].values())} "
          f"parameter tensors and {n_opt} optimizer state tensors equal to "
          f"epoch {start - 1}'s file, plus both schedules; 1 epoch "
          f"({steps} train steps + {eval_batches} eval batches) in "
          f"{secs:.2f} s; total_loss train {hist['train/total_loss'][0]:.6g}"
          f", val {hist['val/total_loss'][0]:.6g}; {save_text(watch.saves)};"
          f" launches {launches}")

    # the saved models alone: no training, no backward kernel
    cfg_inf = copy.deepcopy(cfg)
    set_fields(cfg_inf, {"training.inference_only": True,
                         "training.resume": False})
    zero_counts()
    t0 = time.perf_counter()
    inf = port_main.run(cfg_inf)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = named_counts()
    expect = {"mc_warp_fwd": 2, "epdiff_step_fwd": 2 * n_steps,
              "epdiff_step_bwd": 0, "mc_warp_disp_bwd": 0,
              "mc_warp_fused_bwd": 0, "epdiff_step_solve_fwd": 0,
              "epdiff_step_solve_bwd": 0}
    require(launches == expect, f"inference launches {launches} != {expect}")
    require("train_loss_dict" not in inf, "inference_only trained")
    worst = 0.0
    for t in ("val", "test"):
        want, have = res[f"{t}_performance"], inf[f"{t}_performance"]
        require(want.keys() == have.keys(), f"inference {t}: other metrics")
        for k, v in want.items():
            require(math.isclose(have[k], v, rel_tol=1e-4, abs_tol=1e-6),
                    f"inference {k}: {have[k]} vs the trained run's {v}")
            if v:
                worst = max(worst, abs(have[k] - v) / abs(v))
    print(f"inference: training.inference_only on {run_dir.name}/: reloaded "
          f"model-*.pt, val and test metrics equal the resumed run's within "
          f"relative {worst:.3e} (tol 1e-4) in {secs:.2f} s; launches "
          f"{launches}")
    return res


def grads_of(engine):
    return {f"{n}.{k}": p.grad.detach().clone()
            for n, mod in engine.modules.items()
            for k, p in mod.named_parameters()}


def step_gate(label, what, values_a, grads_a, values_b, grads_b):
    """Two runs of one train step agree: total loss 1e-3 relative, every
    parameter's gradient 5e-2 relative L2. Returns the summary text."""
    tl_a, tl_b = values_a["total_loss"].item(), values_b["total_loss"].item()
    require(abs(tl_a - tl_b) <= 1e-3 * max(1.0, abs(tl_b)),
            f"{label} total_loss: {what} {tl_a} vs {tl_b}")
    rel = {}
    for k, gb in grads_b.items():
        norm = gb.norm().item()
        rel[k] = (grads_a[k] - gb).norm().item() / norm if norm > 0 else \
            grads_a[k].norm().item()
    worst = max(rel, key=rel.get)
    require(rel[worst] <= 5e-2,
            f"{label}: gradient of {worst}: {what} relative L2 {rel[worst]}")
    return (f"{label} {what}: total_loss {tl_a:.6g} vs {tl_b:.6g} (tol 1e-3 "
            f"rel), gradients of {len(rel)} tensors within relative L2 "
            f"{rel[worst]:.3e} (worst {worst}; tol 5e-2), median "
            f"{sorted(rel.values())[len(rel) // 2]:.3e}")


def kernel_vs_plain_step(cfg, batch, label, n_pairs="flagship",
                         frame_size=None):
    """One train step (loss and every parameter's gradient) through the
    kernels and through the plain versions, on the same random weights.
    ``n_pairs`` sizes the joint network (the flagship's T - 1 by default;
    None for ``reg``), ``frame_size`` a ``NetDisplacement2LMA``. Returns a
    factory of fresh engines and the batch on the card."""
    from cardiax_torch.ops import epdiff_kernels as ek
    from cardiax_torch.ops import shooting as sh
    from cardiax_torch.ops import warp_kernels as wk
    from cardiax_torch.train import build_trainer
    if n_pairs == "flagship":
        n_pairs = int(cfg["datasets"]["train"]
                      ["n_myo_frames_to_use_for_regression"]) - 1

    def fresh_engine():
        engine = build_trainer(cfg["training"], None, cfg)
        engine.setup(random_nets(cfg, n_pairs, seed=1, frame_size=frame_size),
                     None, 3)
        return engine

    engine = fresh_engine()
    arrays = engine.to_device(batch)
    before = counts()
    values_k = engine.backward(arrays)
    grads_k = grads_of(engine)
    torch.cuda.synchronize()
    n_steps = n_euler_steps(cfg)
    step_counts = tuple(a - b for a, b in zip(counts(), before))
    expect = (0, 0, 1, 1, 0, n_steps, n_steps) if sh._FUSED_SOLVE \
        else (n_steps, n_steps, 1, 1, 0, 0, 0)
    require(step_counts == expect,
            f"{label}: the kernel train step launched (K2, K3, K1, K4, K5, "
            f"K6, K7) = {step_counts}, not {expect}")
    with plain_path(sh, ek, wk):
        values_p = engine.backward(arrays)
    grads_p = grads_of(engine)
    summary = step_gate(label, "kernel vs plain", values_k, grads_k,
                        values_p, grads_p)
    disp = values_k.get("max_abs_displacement")
    print(f"{summary}; "
          + ("" if disp is None else f"max|u_inv| {disp.item():.3f} px; ")
          + f"launches (K2, K3, K1, K4, K5, K6, K7) {step_counts}")
    return fresh_engine, arrays


def step_time_ms(engine, arrays, reps: int = 10) -> float:
    """Host clock around ``reps`` synchronised train steps, after 2 warm-up
    steps."""
    for _ in range(2):
        engine.train_step(arrays)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.train_step(arrays)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def step_line(label, engine, arrays, what, card):
    """The train step's host time (10 synchronised steps after 2 warm-up
    steps), its device busy time and idle share (profiler), and its peak
    device memory."""
    torch.cuda.reset_peak_memory_stats()
    reps = 10
    step_ms = step_time_ms(engine, arrays, reps)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    busy_ms, prof = profile_steps(lambda: engine.train_step(arrays))
    print(f"{label} train step ({card}): {step_ms:.3f} ms/batch of {what} "
          f"({reps} steps after 2 warm-up steps, host clock); "
          f"{busy_line(busy_ms, step_ms)}; peak device memory "
          f"{peak_gb:.3f} GB")
    return prof


def run_train_step(profile_dir):
    """Kernel path vs plain path on one train step, a 10-step overfit of
    one batch, and the train step's time, at full width."""
    from cardiax_torch.data.datasets import JointDataset
    from cardiax_torch.data.loader import Batcher
    from cardiax_torch.data.synthetic import make_dataset
    cfg = json.loads((ROOT / "configs" / "joint.json").read_text())
    ds_cfg = cfg["datasets"]["train"]
    t_myo = int(ds_cfg["n_myo_frames_to_use_for_regression"])
    batch_size = int(cfg["training"]["batch_size"])
    data = make_dataset(n_subjects=5, slices_per_subject=2, h=128, w=128,
                        n_frames=t_myo, seed=6)
    batch = next(iter(Batcher(JointDataset(data, dataset_config=ds_cfg),
                              batch_size)))
    fresh_engine, arrays = kernel_vs_plain_step(cfg, batch, "train step")
    engine = fresh_engine()

    # overfit one batch: 10 optimiser steps, the loss must fall
    losses = [engine.train_step(arrays)["total_loss"].item()
              for _ in range(10)]
    require(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
            f"overfit: total_loss did not fall: {losses}")
    print(f"overfit: 10 train steps on one batch, total_loss "
          f"{losses[0]:.6g} -> {losses[-1]:.6g}")

    # train step time: host clock around synchronised steps
    engine = fresh_engine()
    reps = 10
    step_ms = step_time_ms(engine, arrays, reps)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for mod in engine.modules.values()
                   for p in mod.parameters())
    print(f"train step: {step_ms:.3f} ms/batch of {batch_size} slices = "
          f"{batch_size / step_ms * 1e3:.1f} slices/s ({reps} steps after 2 "
          f"warm-up steps; {n_params} parameters; peak device memory "
          f"{peak_gb:.2f} GB)")
    if profile_dir:
        busy_ms, prof = profile_steps(lambda: engine.train_step(arrays))
        print(f"train step: {busy_line(busy_ms, step_ms)}"
              f"{busy_turns(lambda: engine.train_step(arrays))}")
        write_profile(prof, Path(profile_dir), "train")


def run_solve(tmp: Path, profile_dir):
    """The fused-solve path (``shooting._FUSED_SOLVE = True``, restored
    after): ``main.run`` as in the train phase, with K6/K7 in place of K2/K3;
    one train step kernel vs plain and fused vs separate solve on the same
    weights and batch; the train step's host time (turns: separate, fused,
    fused, separate) and device time with each."""
    from cardiax_torch.data.datasets import JointDataset
    from cardiax_torch.data.loader import Batcher
    from cardiax_torch.data.synthetic import make_dataset
    from cardiax_torch.ops import shooting as sh
    saved = sh._FUSED_SOLVE
    sh._FUSED_SOLVE = True
    try:
        launches, _, _ = run_train(tmp, "solve")
        cfg = json.loads((ROOT / "configs" / "joint.json").read_text())
        ds_cfg = cfg["datasets"]["train"]
        t_myo = int(ds_cfg["n_myo_frames_to_use_for_regression"])
        batch_size = int(cfg["training"]["batch_size"])
        data = make_dataset(n_subjects=5, slices_per_subject=2, h=128,
                            w=128, n_frames=t_myo, seed=6)
        batch = next(iter(Batcher(
            JointDataset(data, dataset_config=ds_cfg), batch_size)))
        fresh_engine, arrays = kernel_vs_plain_step(cfg, batch,
                                                    "solve train step")
        engine = fresh_engine()
        values_f = engine.backward(arrays)
        grads_f = grads_of(engine)
        sh._FUSED_SOLVE = False
        values_s = engine.backward(arrays)
        grads_s = grads_of(engine)
        sh._FUSED_SOLVE = True
        print(step_gate("solve train step", "fused vs separate solve",
                        values_f, grads_f, values_s, grads_s))

        host, busy = {True: [], False: []}, {}
        for fused in (False, True, True, False):
            sh._FUSED_SOLVE = fused
            host[fused].append(step_time_ms(fresh_engine(), arrays))
        for fused in (False, True):
            sh._FUSED_SOLVE = fused
            engine = fresh_engine()
            busy[fused], prof = profile_steps(
                lambda: engine.train_step(arrays))
        sh._FUSED_SOLVE = True
        if profile_dir:
            write_profile(prof, Path(profile_dir), "solve_train")

        def ms(fused):
            b = "not measured" if busy[fused] is None else \
                f"{busy[fused]:.3f} ms"
            return (f"host {host[fused][0]:.3f}, {host[fused][1]:.3f} ms "
                    f"(mean {sum(host[fused]) / 2:.3f}), device busy {b}")
        print(f"solve train step: step_time_ms fused solve {ms(True)}; "
              f"separate solve {ms(False)} (batch of {batch_size}, 10 steps "
              f"after 2 warm-up steps a turn; device busy from the profiler "
              f"over 3 steps)")
    finally:
        sh._FUSED_SOLVE = saved
    return launches


def run_ops():
    """The public ops with field gradients at the flagship's item shape,
    kernels vs plain versions; launch counts from 0 around the kernel run."""
    from cardiax_torch.ops import (compose_displacements, deform_image,
                                   expmap_svf)
    from cardiax_torch.ops import epdiff_kernels as ek
    from cardiax_torch.ops import shooting as sh
    from cardiax_torch.ops import warp_kernels as wk
    dev = torch.device("cuda")
    n, h, w = 190, 128, 128
    gen = torch.Generator().manual_seed(7)
    inputs = {"v": smooth(gen, (n, 2, h, w), 20.0, dev),
              "outer": smooth(gen, (n, 2, h, w), 6.0, dev),
              "inner": smooth(gen, (n, 2, h, w), 6.0, dev),
              "img": smooth(gen, (n, 1, h, w), 1.0, dev),
              "u": smooth(gen, (n, 2, h, w), 8.0, dev)}
    cots = {k: torch.randn((n, c, h, w), generator=gen).to(dev)
            for k, c in (("svf", 2), ("compose", 2), ("deform", 1))}
    warp_fn = lambda img, d: wk.bilinear_warp_banded(img, d, radius=12)  # noqa: E731

    def run():
        x = {k: t.clone().requires_grad_() for k, t in inputs.items()}
        outs = {"svf": expmap_svf(x["v"], n_squarings=4, warp_radius=8),
                "compose": compose_displacements(x["outer"], x["inner"],
                                                 warp_fn),
                "deform": deform_image(x["img"], x["u"], warp_radius=12,
                                       img_const=False)}
        total = sum((outs[k] * cots[k]).sum() for k in outs)
        names = list(x)
        grads = dict(zip(names, torch.autograd.grad(total, [x[k] for k in
                                                            names])))
        return {k: v.detach() for k, v in outs.items()}, grads

    zero_counts()
    outs_k, grads_k = run()
    torch.cuda.synchronize()
    launches = named_counts()
    # expmap_svf: one K1 and one K5 per squaring; compose: one each per
    # channel; deform_image: one each
    expect = {"mc_warp_fwd": 7, "mc_warp_disp_bwd": 0, "mc_warp_fused_bwd": 7,
              "epdiff_step_fwd": 0, "epdiff_step_bwd": 0,
              "epdiff_step_solve_fwd": 0, "epdiff_step_solve_bwd": 0}
    require(launches == expect, f"ops launches {launches} != {expect}")
    with plain_path(sh, ek, wk):
        outs_p, grads_p = run()
    val_err, grad_rel = {}, {}
    for k, ref in outs_p.items():
        val_err[k] = (outs_k[k] - ref).abs().max().item()
        tol = 1e-5 * max(1.0, ref.abs().max().item())
        require(val_err[k] <= tol, f"ops {k}: kernel vs plain {val_err[k]} "
                f"> {tol}")
        require(bool(torch.isfinite(outs_k[k]).all()), f"ops {k}: non-finite")
    for k, ref in grads_p.items():
        grad_rel[k] = ((grads_k[k] - ref).norm() / ref.norm()).item()
        require(grad_rel[k] <= 1e-4, f"ops d/d {k}: kernel vs plain relative "
                f"L2 {grad_rel[k]}")
    u_max = outs_k["svf"].abs().max().item()
    print(f"ops (190 items, 128^2): expmap_svf R=8 x4 squarings (max|u| "
          f"{u_max:.2f} px), compose_displacements with "
          f"bilinear_warp_banded R=12, deform_image R=12 img_const=False: "
          f"values max|kernel-plain| {json.dumps(val_err)} (tol 1e-5 of "
          f"range), gradients relative L2 {json.dumps(grad_rel)} (tol 1e-4); "
          f"launches {launches}")
    return launches


def run_reg(tmp: Path, card: str, profile_dir):
    """``main.run`` on configs/reg.json at its full width (16 features, 3
    levels, 5 Euler steps, batch 10, final-warp radius 12) over frame pairs
    of synthetic 128^2 slices with T=20, for 2 epochs with checkpoints;
    launch counts from 0 around it. Then one reg train step kernel vs
    plain, and its host and device time and peak device memory."""
    from cardiax_torch import main as port_main
    from cardiax_torch.data.datasets import BasicRegistrationDataset
    from cardiax_torch.data.loader import Batcher
    from cardiax_torch.data.synthetic import (make_dataset,
                                              make_registration_pairs,
                                              save_npy)
    from cardiax_torch.io.checkpoints import CheckpointManager
    cfg = json.loads((ROOT / "configs" / "reg.json").read_text())
    pairs = make_registration_pairs(make_dataset(
        n_subjects=4, slices_per_subject=1, h=128, w=128, n_frames=20,
        seed=9))
    require(len(pairs) >= 60, f"reg: only {len(pairs)} pairs")
    npy = tmp / "pairs.npy"
    save_npy(str(npy), pairs)
    n_train, n_val, n_test = 40, 10, 10
    changes = {
        "training.epochs": 2,
        "saving.saving_dir": str(tmp / "reg"),
        "data.npy_filename": str(npy),
        "data_split": {"method": "by_count", "splits": {
            "train": {"count": n_train}, "val": {"count": n_val},
            "test": {"count": n_test}}},
    }
    set_fields(cfg, changes)
    print(f"reg: configs/reg.json with {json.dumps(changes)} ({len(pairs)} "
          f"pairs of 128^2 frames from 4 slices, T=20)")
    epochs = changes["training.epochs"]
    batch_size = int(cfg["training"]["batch_size"])
    n_steps = n_euler_steps(cfg)
    vis_every = max(1, int(float(cfg["others"]["wandb_visualize_interval"])
                           * epochs))
    n_vis = len(range(0, epochs, vis_every))
    run_cfg = copy.deepcopy(cfg)
    zero_counts()
    t0 = time.perf_counter()
    with watched_main_run() as watch:
        res = port_main.run(run_cfg)
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = named_counts()
    train_steps = epochs * math.ceil(n_train / batch_size)
    # val each epoch, the first val batch of each figure epoch (the reg
    # batch has no strain matrix, so no figure is drawn), final val and test
    eval_batches = epochs * math.ceil(n_val / batch_size) + n_vis \
        + math.ceil(n_val / batch_size) + math.ceil(n_test / batch_size)
    expect = {"mc_warp_fwd": train_steps + eval_batches,
              "epdiff_step_fwd": n_steps * (train_steps + eval_batches),
              "epdiff_step_bwd": n_steps * train_steps,
              "mc_warp_disp_bwd": train_steps, "mc_warp_fused_bwd": 0,
              "epdiff_step_solve_fwd": 0, "epdiff_step_solve_bwd": 0}
    require(launches == expect, f"reg launches {launches} != {expect}")
    hist = res["train_loss_dict"]
    for key in ("train/total_loss", "val/total_loss"):
        require(len(hist[key]) == epochs
                and all(math.isfinite(v) for v in hist[key]),
                f"reg {key} per epoch: {hist[key]}")
    perf = {k: v for t in ("val", "test")
            for k, v in res[f"{t}_performance"].items()}
    require(all(math.isfinite(v) for v in perf.values())
            and "final-test/reconstruction_mse" in perf,
            f"reg: metrics {perf}")
    # the scheme injects the LDDMM energy into a config without losses
    require(set(run_cfg["losses"]) == {"registration_reconstruction"},
            f"reg: losses {run_cfg['losses']}")
    saved = CheckpointManager(tmp / "reg" / "checkpoints").epochs()
    require(saved == list(range(epochs)), f"reg: checkpoints {saved}")
    failed = [str(w.message) for w in watch.caught
              if "periodic visualization failed" in str(w.message)]
    print(f"reg: main.run {epochs} epochs x {train_steps // epochs} train "
          f"steps + {eval_batches} eval batches in {secs:.2f} s; total_loss "
          f"per epoch train {[round(v, 6) for v in hist['train/total_loss']]}"
          f", val {[round(v, 6) for v in hist['val/total_loss']]}; test "
          f"reconstruction_mse {perf['final-test/reconstruction_mse']:.6g}; "
          f"checkpoints of epochs {saved} ({save_text(watch.saves)}); "
          f"{failed[0] if failed else 'no figure (no strain matrix)'}; "
          f"launches {launches}")

    ds = BasicRegistrationDataset(pairs[:batch_size],
                                  dataset_config=cfg["datasets"]["train"])
    batch = next(iter(Batcher(ds, batch_size)))
    fresh_engine, arrays = kernel_vs_plain_step(cfg, batch, "reg train step",
                                                n_pairs=None)
    prof = step_line("reg", fresh_engine(), arrays, f"{batch_size} pairs",
                     card)
    if profile_dir:
        write_profile(prof, Path(profile_dir), "reg_train")
    return launches


# JAX's metric keys of each config after ``test`` (as
# ``final-{dataset}/{key}``): the scheme's performance and a loss_ key per
# loss value. tests/test_torch_lma_schemes.py and test_torch_regression.py
# hold the port's keys and values to JAX's on the CPU.
SCHEME_METRICS = {
    "lma": ("sector_error", "loss_TOS_regression", "loss_total_loss"),
    "lma_classification": ("accuracy", "precision", "recall",
                           "loss_sector_CE", "loss_total_loss"),
    "strainmat_pred": ("strainmat_mse", "loss_strainmat_MSE",
                       "loss_total_loss"),
    "strainmat_lma": ("sector_error", "loss_strainmat_MSE",
                      "loss_TOS_regression", "loss_total_loss"),
    "joint_reg_regression": ("sector_error",
                             "loss_registration_reconstruction",
                             "loss_TOS_regression", "loss_total_loss"),
}


def scheme_main_run(name, npy, tmp: Path, split):
    """``main.run`` on configs/{name}.json with only its data, split,
    epochs (2) and saving_dir changed, checkpoints on: finite losses each
    epoch, JAX's metric keys, a checkpoint each epoch. Returns the config,
    the result, the launches and the host seconds."""
    from cardiax_torch import main as port_main
    from cardiax_torch.io.checkpoints import CheckpointManager
    cfg = json.loads((ROOT / "configs" / f"{name}.json").read_text())
    changes = {"training.epochs": 2,
               "saving.saving_dir": str(tmp / name),
               "data.npy_filename": str(npy),
               "data_split": {"method": "by_count", "splits": split}}
    set_fields(cfg, changes)
    zero_counts()
    t0 = time.perf_counter()
    with watched_main_run() as watch:
        res = port_main.run(copy.deepcopy(cfg))
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = named_counts()
    hist = res["train_loss_dict"]
    for key in ("train/total_loss", "val/total_loss"):
        require(len(hist[key]) == 2
                and all(math.isfinite(v) for v in hist[key]),
                f"schemes {name}: {key} per epoch: {hist[key]}")
    for t in ("val", "test"):
        perf = res[f"{t}_performance"]
        want = {f"final-{t}/{k}" for k in SCHEME_METRICS[name]}
        require(set(perf) == want,
                f"schemes {name}: {t} metrics {sorted(perf)} != "
                f"{sorted(want)}")
        require(all(math.isfinite(v) for v in perf.values()),
                f"schemes {name}: {t} metrics {perf}")
    saved = CheckpointManager(tmp / name / "checkpoints").epochs()
    require(saved == [0, 1], f"schemes {name}: checkpoints {saved}")
    test = {k.split("/")[1]: round(v, 6)
            for k, v in res["test_performance"].items()}
    print(f"schemes {name}: main.run with {json.dumps(changes)} in "
          f"{secs:.2f} s; total_loss per epoch train "
          f"{[round(v, 6) for v in hist['train/total_loss']]}, val "
          f"{[round(v, 6) for v in hist['val/total_loss']]}; test {test}; "
          f"checkpoints of epochs {saved} ({save_text(watch.saves)})")
    return cfg, launches


def run_schemes(tmp: Path, card: str, profile_dir):
    """The four schemes of ``cardiax_torch.train.schemes`` beside the
    flagship and ``reg``: ``main.run`` on configs/lma.json,
    lma_classification.json, strainmat_pred.json, strainmat_lma.json and
    joint_reg_regression.json (synthetic 128^2 slices, T=20, with
    displacement fields; frame pairs for the last); exact launches of
    joint_registration_regression (K2/K3 5 a train step, K1/K4 1, K5-K7
    none); its train step on slice batches as JAX's own test builds them
    (4 slices x 19 pairs = 76 items of 128^2) kernel vs plain, with its
    host and device time and peak memory; and the train step time of the
    other four configs."""
    from cardiax_torch.data.datasets import build_datasets
    from cardiax_torch.data.loader import Batcher
    from cardiax_torch.data.synthetic import (add_displacement_fields,
                                              make_dataset,
                                              make_registration_pairs,
                                              save_npy)
    from cardiax_torch.train import build_trainer
    slices = add_displacement_fields(make_dataset(
        n_subjects=6, slices_per_subject=5, h=128, w=128, n_frames=20,
        seed=10), seed=10)
    npy = tmp / "slices.npy"
    save_npy(str(npy), slices)
    split = {"train": {"count": 20}, "val": {"count": 5},
             "test": {"count": 5}}
    cfgs = {name: scheme_main_run(name, npy, tmp, split)[0]
            for name in ("lma", "lma_classification", "strainmat_pred",
                         "strainmat_lma")}

    # joint_registration_regression: main.run gives every pair its own
    # slice id (load_data), so its batches are 4 slices x 1 pair
    pair_slices = make_dataset(n_subjects=4, slices_per_subject=1, h=128,
                               w=128, n_frames=20, seed=11)
    pairs = make_registration_pairs(add_displacement_fields(pair_slices,
                                                            seed=11))
    require(len(pairs) == 76, f"schemes: {len(pairs)} pairs, not 76")
    pairs_npy = tmp / "pairs.npy"
    save_npy(str(pairs_npy), pairs)
    n_train, n_val, n_test = 40, 18, 18
    cfg, launches = scheme_main_run(
        "joint_reg_regression", pairs_npy, tmp,
        {"train": {"count": n_train}, "val": {"count": n_val},
         "test": {"count": n_test}})
    batch_size = int(cfg["training"]["batch_size"])
    n_steps = n_euler_steps(cfg)
    vis_every = max(1, int(float(cfg["others"]["wandb_visualize_interval"])
                           * 2))
    # val each epoch, the first val batch of each figure epoch, final val
    # and test
    train_steps = 2 * math.ceil(n_train / batch_size)
    eval_batches = 2 * math.ceil(n_val / batch_size) \
        + len(range(0, 2, vis_every)) + math.ceil(n_val / batch_size) \
        + math.ceil(n_test / batch_size)
    expect = {"mc_warp_fwd": train_steps + eval_batches,
              "epdiff_step_fwd": n_steps * (train_steps + eval_batches),
              "epdiff_step_bwd": n_steps * train_steps,
              "mc_warp_disp_bwd": train_steps, "mc_warp_fused_bwd": 0,
              "epdiff_step_solve_fwd": 0, "epdiff_step_solve_bwd": 0}
    require(launches == expect,
            f"schemes joint_reg_regression launches {launches} != {expect}")
    print(f"schemes joint_reg_regression: {train_steps} train steps + "
          f"{eval_batches} eval batches of {batch_size} slices x 1 pair; "
          f"launches {launches}")

    # the slice batches of JAX's own test: the pairs' slice ids kept
    dataset = build_datasets({"train": cfg["datasets"]["train"]},
                             {"train": {"data": pairs}}, cfg)["train"]
    engine = build_trainer(cfg["training"], None, cfg)
    loader = engine.scheme.make_loader(dataset, batch_size, shuffle=False)
    batch = next(iter(loader))
    require(batch["source_img"].shape[:2] == (4, 19)
            and batch["pair_mask"].all(),
            f"schemes: slice batch {batch['source_img'].shape}")
    fresh_engine, arrays = kernel_vs_plain_step(
        cfg, batch, "joint_reg_regression train step", n_pairs=None,
        frame_size=batch["source_img"].shape[-2:])
    prof = step_line("joint_reg_regression", fresh_engine(), arrays,
                     "4 slices x 19 pairs (76 items of 128^2)", card)
    if profile_dir:
        write_profile(prof, Path(profile_dir), "regression_train")

    # the other four configs' train steps, random weights
    for name, c in cfgs.items():
        ds_cfg = c["datasets"]["train"]
        ds = build_datasets({"train": ds_cfg},
                            {"train": {"data": slices}}, c)["train"]
        bs = int(c["training"]["batch_size"])
        engine = build_trainer(c["training"], None, c)
        engine.setup(random_nets(c, None, seed=1), None, 3)
        arrays = engine.to_device(next(iter(Batcher(ds, bs))))
        step_line(name, engine, arrays, f"{bs} slices", card)
    return launches


def large_config():
    """configs/joint.json's networks, losses and optimizers at the settings
    of tools/bench_large.py: batch 2, T=8 (7 pairs), Ts=16, 5 Euler steps,
    final-warp radius 12."""
    cfg = json.loads((ROOT / "configs" / "joint.json").read_text())
    cfg["training"]["batch_size"] = 2
    for ds in cfg["datasets"].values():
        ds["n_myo_frames_to_use_for_regression"] = 8
        ds["n_strainmat_frames_to_use_for_regression"] = 16
    net = cfg["networks"]["joint_register_strainmat"]
    net.update(n_strain_matrix_frames=16, n_integration_steps=5,
               final_warp_radius=12)
    cfg["networks"]["LMA"]["n_frames"] = 16
    return cfg


def run_large(tmp: Path, profile_dir):
    """``main.run`` at 768x512 frames for 2 epochs (launch counts from 0
    around it), then one train step kernel vs plain, its host and device
    time and its peak device memory."""
    from cardiax_torch import main as port_main
    from cardiax_torch.data.datasets import JointDataset
    from cardiax_torch.data.loader import Batcher
    from cardiax_torch.data.synthetic import make_dataset, save_npy
    h, w, t_myo, epochs = 768, 512, 8, 2
    cfg = large_config()
    data = make_dataset(n_subjects=4, slices_per_subject=2, h=h, w=w,
                        n_frames=t_myo, seed=8)
    npy = tmp / "slices_768x512.npy"
    save_npy(str(npy), data)
    cfg["training"]["epochs"] = epochs
    cfg["saving"].update(saving_dir=str(tmp / "run_large"),
                         save_checkpoint=False)
    cfg["others"]["wandb_visualize_interval"] = 0
    cfg["data"]["npy_filename"] = str(npy)
    cfg["data_split"] = {"method": "by_count", "splits": {
        "train": {"count": 4}, "val": {"count": 2}, "test": {"count": 2}}}
    n_steps = 5
    print(f"large: configs/joint.json at {h}x{w} frames, batch 2, T={t_myo}, "
          f"Ts=16, {n_steps} Euler steps on the {h // 2}x{w // 2} grid, "
          f"final-warp radius 12; 8 synthetic slices (train 4, val 2, "
          f"test 2), {epochs} epochs")
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = port_main.run(cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    run_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = named_counts()
    train_steps = epochs * 2
    eval_batches = epochs + 2      # val each epoch, final val and test
    expect = {"mc_warp_fwd": train_steps + eval_batches,
              "epdiff_step_fwd": n_steps * (train_steps + eval_batches),
              "epdiff_step_bwd": n_steps * train_steps,
              "mc_warp_disp_bwd": train_steps, "mc_warp_fused_bwd": 0,
              "epdiff_step_solve_fwd": 0, "epdiff_step_solve_bwd": 0}
    require(launches == expect, f"large launches {launches} != {expect}")
    hist = res["train_loss_dict"]
    for key in ("train/total_loss", "val/total_loss"):
        require(len(hist[key]) == epochs
                and all(math.isfinite(v) for v in hist[key]),
                f"large {key} per epoch: {hist[key]}")
    perf = {k: v for t in ("val", "test")
            for k, v in res[f"{t}_performance"].items()}
    require(all(math.isfinite(v) for v in perf.values()),
            f"large: non-finite metric: {perf}")
    print(f"large: main.run {epochs} epochs x 2 train steps + {eval_batches} "
          f"eval batches in {secs:.2f} s; total_loss per epoch train "
          f"{[round(v, 6) for v in hist['train/total_loss']]}, val "
          f"{[round(v, 6) for v in hist['val/total_loss']]}; peak device "
          f"memory {run_peak_gb:.2f} GB; launches {launches}")

    ds = JointDataset(data, dataset_config=cfg["datasets"]["train"])
    batch = next(iter(Batcher(ds, 2)))
    fresh_engine, arrays = kernel_vs_plain_step(cfg, batch,
                                                "large train step")
    engine = fresh_engine()
    torch.cuda.reset_peak_memory_stats()
    reps = 10
    step_ms = step_time_ms(engine, arrays, reps)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    busy_ms, prof = profile_steps(lambda: engine.train_step(arrays))
    print(f"large train step: {step_ms:.3f} ms/batch of 2 slices = "
          f"{2 / step_ms * 1e3:.2f} slices/s ({reps} steps after 2 warm-up "
          f"steps, host clock); {busy_line(busy_ms, step_ms)}; peak device "
          f"memory {peak_gb:.2f} GB"
          f"{busy_turns(lambda: engine.train_step(arrays))}")
    if profile_dir:
        write_profile(prof, Path(profile_dir), "large_train")
    return launches


# --------------------------------------------------------------------------- #
# dispatch: the engine's modes on the card, CUDA graphs against the loop      #
# --------------------------------------------------------------------------- #

def state_equal(a, b) -> bool:
    """Nested dicts/lists of tensors and numbers, equal bit for bit."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype \
            and a.shape == b.shape and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() \
            and all(state_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(state_equal(x, y)
                                        for x, y in zip(a, b))
    return a == b


def final_params(res):
    """The trained (best) parameters of a ``main.run`` result, on the CPU."""
    return {name[:-len("_model")]: {k: v.detach().cpu().clone()
                                    for k, v in b.module.state_dict().items()}
            for name, b in res["models"].items() if name.endswith("_model")}


def run_diff(a, b, ref):
    """How run ``a`` differs from run ``b``, each (per-epoch metrics,
    parameters, optimizer state or None), ``ref`` the parameters both
    started from: whether bit-equal; the worst relative difference of a
    per-epoch total loss; and how far apart the runs moved each model,
    ||(a - ref) - (b - ref)|| / ||b - ref|| over all its floating
    tensors, for the model where that is largest."""
    (ma, pa, oa), (mb, pb, ob) = a, b
    exact = ma == mb and state_equal(pa, pb) \
        and (oa is None or state_equal(oa, ob))
    loss_rel = max((abs(x - y) / max(1.0, abs(y))
                    for key in ("train/total_loss", "val/total_loss")
                    for x, y in zip(ma[key], mb[key])), default=0.0)
    move_rel, worst = 0.0, ""
    for name, state in pb.items():
        d2 = m2 = 0.0
        for k, v in state.items():
            if not v.is_floating_point():
                continue
            v = v.detach().double().cpu()
            d2 += float(((pa[name][k].detach().double().cpu() - v) ** 2)
                        .sum())
            m2 += float(((v - ref[name][k].double().cpu()) ** 2).sum())
        rel = math.sqrt(d2 / m2) if m2 > 0 else (0.0 if d2 == 0 else math.inf)
        if rel >= move_rel:
            move_rel, worst = rel, name
    return {"exact": exact, "loss_rel": loss_rel, "move_rel": move_rel,
            "worst": worst}


def diff_text(diff) -> str:
    return (f"{'bit-equal' if diff['exact'] else 'not bit-equal'} "
            f"(per-epoch total loss max rel diff {diff['loss_rel']:.3e}; "
            f"the runs moved {diff['worst']} {diff['move_rel']:.3e} of its "
            f"move apart)")


def gate_runs(label, diff, limits) -> str:
    """``limits`` None: metrics, parameters and optimizer state
    ``torch.equal``; else (total loss, move) limits: the worst per-epoch
    total loss within ``limits[0]`` relative, every model's move within
    ``limits[1]`` of itself (``run_diff``)."""
    if limits is None:
        require(diff["exact"], f"{label}: not bit-equal: {diff_text(diff)}")
    else:
        require(diff["loss_rel"] <= limits[0]
                and diff["move_rel"] <= limits[1],
                f"{label}: outside the limits {limits}: {diff_text(diff)}")
    return f"{label}: {diff_text(diff)}"


@contextlib.contextmanager
def planted(fault: str):
    """A fault planted in the engine for a control run. "no reg step":
    the registration net's optimizer never steps; "lr late": every step
    takes the learning rates of the step before (the schedules' first
    step is skipped)."""
    from cardiax_torch.train.engine import TrainerEngine
    update, schedules = TrainerEngine._update, TrainerEngine._schedules_step

    def update_without_reg(self, arrays):
        values = self.backward(arrays)
        for name, (opt, _) in self.optimizers.items():
            if name != "joint_register_strainmat":
                opt.step()
        return values

    def schedules_late(self):
        if getattr(self, "_planted_skipped", False):
            schedules(self)
        self._planted_skipped = True

    if fault == "no reg step":
        TrainerEngine._update = update_without_reg
    elif fault == "lr late":
        TrainerEngine._schedules_step = schedules_late
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        TrainerEngine._update, TrainerEngine._schedules_step = \
            update, schedules


def ckpt_state(run_dir: Path, epoch: int):
    from cardiax_torch.io.checkpoints import CheckpointManager
    state = CheckpointManager(run_dir / "checkpoints").restore(epoch)
    return state["params"], state["opt_states"]


def epoch_walls(watch, pipelined: bool = False) -> str:
    """Each epoch's host wall (``host_profile`` ``total``; under pipelining
    the cadence, the difference of consecutive ``t_done``) and, where
    checkpoints are saved, the save's share (``ckpt``)."""
    rows = watch.engines[0][0].host_profile_rows
    if pipelined:
        return fmt_list([b["t_done"] - a["t_done"]
                         for a, b in zip(rows, rows[1:])])
    return (f"{fmt_list([r['total'] for r in rows])} (checkpoint "
            f"{fmt_list([r['ckpt'] for r in rows])})")


def fmt_list(xs) -> str:
    return "[" + ", ".join(f"{x * 1e3:.3f}" for x in xs) + "] ms"


def dispatch_main_run(base_cfg, label, changes, expect_launches):
    """``main.run`` on the train phase's config with ``changes``; launch
    counts from 0 around it must equal ``expect_launches`` (the same work).
    Returns (result, watch, host seconds)."""
    from cardiax_torch import main as port_main
    cfg = copy.deepcopy(base_cfg)
    set_fields(cfg, changes)
    zero_counts()
    t0 = time.perf_counter()
    with watched_main_run() as watch:
        res = port_main.run(cfg)
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = named_counts()
    if expect_launches is not None:
        require(launches == expect_launches,
                f"{label}: launches {launches} != {expect_launches}")
    hist = res["train_loss_dict"]
    require(all(math.isfinite(v) for key in ("train/total_loss",
                                             "val/total_loss")
                for v in hist[key]), f"{label}: losses {hist}")
    return res, watch, secs, launches


def profiled_launches(step):
    """The K1-K4 launches the counters add over one ``step()`` and the
    kernels the profiler saw on the card over the same call, by name."""
    from torch.profiler import ProfilerActivity, profile

    names = {"mc_warp_fwd": ("mc_warp_fwd_kernel",),
             "epdiff_step_fwd": ("epdiff_step_fwd_kernel",),
             "epdiff_step_bwd": ("epdiff_step_bwd_tiled",
                                 "epdiff_step_bwd_chunked"),
             "mc_warp_disp_bwd": ("mc_warp_disp_bwd_kernel",)}
    torch.cuda.synchronize()
    before = named_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    after = named_counts()
    counted = {k: after[k] - before[k] for k in names}
    seen = {k: 0 for k in names}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for k, subs in names.items():
                if any(sub in e.name for sub in subs):
                    seen[k] += 1
    return counted, seen


def timed_ms(fn, steps_per_call: int, calls: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / (calls * steps_per_call) * 1e3


def memory_gb(fn, calls: int = 3):
    """(peak allocated, growth of the reserved memory) in GB over
    ``calls`` calls of ``fn`` from an emptied cache: for a graph the first
    calls warm it up and capture it, and its private pool stays reserved."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reserved = torch.cuda.memory_reserved()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() / 1e9,
            (torch.cuda.memory_reserved() - reserved) / 1e9)


def sm_clock_mhz(fn, seconds: float = 1.0):
    """The card's mean SM clock while ``fn`` runs back to back for about
    ``seconds`` (``nvidia-smi`` sampled every 20 ms), or None."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits", "-lms", "20"], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        proc.stdout.readline()              # sampling has started
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
        torch.cuda.synchronize()
    finally:
        proc.terminate()
        try:
            out, _ = proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    vals = [float(x) for x in out.split() if x.replace(".", "", 1).isdigit()]
    return sum(vals) / len(vals) if vals else None


def turns_line(label, loop, graph, card, what, profile_dir=None) -> dict:
    """``loop``/``graph``: (fn, steps a call). Peak memory of each (loop
    first, from an emptied cache; the graph's includes its warm-up and
    capture), host time a step in turns loop, graph, graph, loop (>= 10
    synchronised steps a turn), device busy a step from the profiler, the
    idle share, and the mean SM clock over a second of steps; with
    ``profile_dir`` each mode's profiler table. Prints one line; returns
    the numbers."""
    fns = {"loop": loop, "graph": graph}
    mem = {w: memory_gb(fns[w][0]) for w in ("loop", "graph")}
    host = {"loop": [], "graph": []}
    for w in ("loop", "graph", "graph", "loop"):
        fn, n = fns[w]
        host[w].append(timed_ms(fn, n, max(1, math.ceil(10 / n))))
    out = {}
    parts = []
    for w in ("loop", "graph"):
        fn, n = fns[w]
        busy, prof = profile_steps(fn)
        busy = None if busy is None else busy / n
        spans = device_union_ms(prof, annotations=True)
        spans = None if spans is None else spans / 3 / n
        if profile_dir:
            write_profile(prof, Path(profile_dir),
                          f"dispatch_{label.replace(' ', '_')}_{w}",
                          f"3 calls of {n} {label}{'s' if n > 1 else ''}, "
                          f"{w}")
        mhz = sm_clock_mhz(fn)
        h = sum(host[w]) / len(host[w])
        out[w] = {"host_ms": host[w], "busy_ms": busy, "sm_mhz": mhz,
                  "busy_with_spans_ms": spans,
                  "peak_alloc_gb": mem[w][0], "reserved_gb": mem[w][1]}
        idle = "not measured" if busy is None else f"{1 - busy / h:.1%}"
        parts.append(
            f"{w} host {', '.join(f'{x:.3f}' for x in host[w])} ms/step, "
            f"device busy "
            f"{'not measured' if busy is None else f'{busy:.3f} ms'}/step "
            f"({'not measured' if spans is None else f'{spans:.3f} ms'} "
            f"with the annotation spans), idle {idle}, SM clock "
            f"{'not measured' if mhz is None else f'{mhz:.0f} MHz'}, peak "
            f"allocated {mem[w][0]:.3f} GB, reserved +{mem[w][1]:.3f} GB")
    print(f"dispatch {label} ({what}; {card}; turns loop, graph, graph, "
          f"loop): " + "; ".join(parts))
    return out


def dispatch_engine(cfg, n_pairs, seed=1, frame_size=None):
    from cardiax_torch.train import build_trainer
    engine = build_trainer(cfg["training"], None, cfg)
    engine.setup(random_nets(cfg, n_pairs, seed=seed, frame_size=frame_size),
                 None, 3)
    return engine


def check_prefetch(cfg) -> str:
    """``PrefetchBatcher`` on the card over the flagship's host loader
    (full-width items, batch 10, shuffled): every batch's numeric fields
    ``torch.equal`` to the host batch, the rest passed through."""
    from cardiax_torch.data.datasets import JointDataset
    from cardiax_torch.data.loader import Batcher
    from cardiax_torch.data.prefetch import PrefetchBatcher
    from cardiax_torch.data.synthetic import make_dataset
    t_myo = int(cfg["datasets"]["train"]["n_myo_frames_to_use_for_regression"])
    ds = JointDataset(make_dataset(n_subjects=5, slices_per_subject=5, h=128,
                                   w=128, n_frames=t_myo, seed=12),
                      dataset_config=cfg["datasets"]["train"])
    bs = int(cfg["training"]["batch_size"])
    host = list(Batcher(ds, bs, shuffle=True, seed=4))
    dev = list(PrefetchBatcher(Batcher(ds, bs, shuffle=True, seed=4),
                               torch.device("cuda")))
    n_fields = 0
    require(len(dev) == len(host), "prefetch: other batch count")
    for a, b in zip(dev, host):
        require(a.keys() == b.keys(), "prefetch: other fields")
        for k, v in b.items():
            if isinstance(v, np.ndarray) and v.dtype.kind in "fiub":
                require(a[k].is_cuda and torch.equal(
                    a[k].cpu(), torch.from_numpy(v)),
                    f"prefetch: field {k} differs")
                n_fields += 1
            else:
                require(a[k] is v or a[k] == v, f"prefetch: field {k}")
    return (f"PrefetchBatcher over the flagship host loader ({len(ds)} "
            f"items, batch {bs}): {len(dev)} batches, {n_fields} numeric "
            f"fields on the card torch.equal to the host batches")


def graph_vs_loop_train(label, cfg, dataset, n_pairs, card, what,
                        profile_dir=None):
    """A loop engine (``train_step`` on one pre-uploaded batch) and a graph
    engine (``EpochRunner`` over ``dataset`` resident on the card, 3 steps
    an epoch) from the same weights, timed in turns; then one profiled
    graph epoch: the counted K1-K4 launches equal the kernels the trace
    shows."""
    from cardiax_torch.data.loader import Batcher, DeviceBatcher
    from cardiax_torch.train.graphs import EpochRunner
    bs = int(cfg["training"]["batch_size"])
    loop_eng = dispatch_engine(cfg, n_pairs)
    arrays = loop_eng.to_device(next(iter(Batcher(dataset, bs))))
    graph_eng = dispatch_engine(cfg, n_pairs)
    loader = DeviceBatcher(dataset, bs, shuffle=True, seed=3,
                           device=torch.device("cuda"))
    runner = EpochRunner(loader, graph_eng._update,
                         after_step=graph_eng._schedules_step)
    n = len(loader)

    def graph_epoch():
        return runner(*loader.epoch_plan())
    out = turns_line(label, (lambda: loop_eng.train_step(arrays), 1),
                     (graph_epoch, n), card, what, profile_dir)
    vals = graph_epoch()[:, list(runner.keys).index("total_loss")]
    require(bool(torch.isfinite(vals).all()), f"{label}: graph losses {vals}")
    counted, seen = profiled_launches(graph_epoch)
    require(counted == seen and all(v > 0 for v in counted.values()),
            f"{label}: launches counted over one replayed epoch {counted} "
            f"!= the kernels in its trace {seen}")
    print(f"dispatch {label}: one replayed epoch of {n} steps: counted "
          f"launches {counted} = the kernels in its profiler trace"
          f"{replay_busy_turns(loader, graph_eng, n)}")
    return out


def replay_busy_turns(loader, engine, n: int) -> str:
    """With ``--baseline``: the device time a replayed step of ``engine``
    over ``loader`` (``n`` steps an epoch) in turns baseline, this tree,
    this tree, baseline, each turn on an epoch captured with that tree's
    kernels (``profile_steps`` of 3 epochs)."""
    if not BASELINE:
        return ""
    from cardiax_torch.train.graphs import EpochRunner
    turns = []
    for base in (True, False, False, True):
        with baseline_kernels(base):
            runner = EpochRunner(loader, engine._update,
                                 after_step=engine._schedules_step)
            runner(*loader.epoch_plan())       # eager, capture, replay
            busy, _ = profile_steps(lambda: runner(*loader.epoch_plan()))
        turns.append(None if busy is None else busy / n)
        del runner
        gc.collect()
    return ("; device busy a replayed step in turns baseline, this, this, "
            "baseline: " + ", ".join(fmt_ms(t) for t in turns))


def run_dispatch(tmp: Path, card: str, train_cfg, train_res, resumed_res,
                 train_launches):
    """JAX's dispatch on the card: ``auto`` engages the resident data, the
    fused (CUDA graph) train and val steps and the combined pass (gated in
    the train phase), and the pipeline once checkpoints are off; graph vs
    step loop, with two planted faults as controls; fused resume; cuFFT
    under capture; ``PrefetchBatcher``; eval_pipeline. Runs
    under ``device.deterministic`` (as the train phase does), so two runs
    of the same work can be compared bit for bit."""
    from cardiax_torch.data.datasets import JointDataset
    from cardiax_torch.data.loader import Batcher
    from cardiax_torch.data.synthetic import make_dataset
    from cardiax_torch.train.graphs import StepGraph
    fused_dir = Path(train_cfg["saving"]["saving_dir"])
    n_train = math.ceil(25 / int(train_cfg["training"]["batch_size"]))

    # --- the step loop twice: does it reproduce itself bit for bit? -------
    loops = []
    for i in range(2):
        res, watch, secs, _ = dispatch_main_run(train_cfg, f"loop {i}", {
            "training.epoch_fuse": False,
            "training.device_data_cache": False,
            "saving.saving_dir": str(tmp / f"loop{i}")}, train_launches)
        eng = watch.engines[0][0]
        require(eng.last_fuse_engaged == (False, False)
                and not eng.last_pipeline_engaged,
                f"loop {i}: the fused path engaged")
        # 2 epochs of the train batches and the one val batch, each carried
        # to the card by the step loop's PrefetchBatcher
        require(watch.prefetched == 2 * (n_train + 1),
                f"loop {i}: {watch.prefetched} batches prefetched, not "
                f"{2 * (n_train + 1)}")
        loops.append((res, watch, secs))
    ref = loops[0][1].initial[0]
    require(len(loops[1][1].initial) == 1
            and state_equal(loops[1][1].initial[0], ref),
            "the two loop runs did not start from the same parameters")

    def run_of(res, run_dir, epoch):
        params, opt = ckpt_state(run_dir, epoch)
        return res["train_loss_dict"], params, opt

    loop_a = run_of(loops[0][0], tmp / "loop0", 1)
    loop_b = run_of(loops[1][0], tmp / "loop1", 1)
    loop_diff = run_diff(loop_a, loop_b, ref)
    # bit-reproducible: the graph path is held to torch.equal; else to 4x
    # the loop's own spread, which the controls below must exceed
    limits = None if loop_diff["exact"] else (
        4 * loop_diff["loss_rel"], 4 * loop_diff["move_rel"])
    print(f"dispatch: step loop vs step loop (epoch_fuse false, "
          f"device_data_cache false, deterministic mode; 2 epochs, "
          f"{loops[0][1].prefetched} batches each through PrefetchBatcher; "
          f"the epoch-1 checkpoint's parameters and optimizer state): "
          f"{diff_text(loop_diff)}; so the graph path is held to "
          + ("torch.equal" if limits is None else
             f"total loss {limits[0]:.3e} relative an epoch and every "
             f"model's move {limits[1]:.3e} of itself (4x loop vs loop)"))
    fused = run_of(train_res, fused_dir, 1)
    print("dispatch: " + gate_runs("fused (CUDA graphs) vs step loop",
                                   run_diff(fused, loop_a, ref), limits))

    # --- controls: planted faults on the graph path must fail that gate --
    for fault in ("no reg step", "lr late"):
        run_dir = tmp / f"control_{fault.replace(' ', '_')}"
        with planted(fault):
            res, _, _, _ = dispatch_main_run(
                train_cfg, f"control {fault}",
                {"saving.saving_dir": str(run_dir)}, None)
        diff = run_diff(run_of(res, run_dir, 1), loop_a, ref)
        caught = not diff["exact"] if limits is None else (
            diff["loss_rel"] > limits[0] or diff["move_rel"] > limits[1])
        require(caught, f"control {fault}: the graph-vs-loop gate passes a "
                        f"planted fault: {diff_text(diff)}")
        print(f"dispatch: control, fused with a planted fault ({fault}) vs "
              f"step loop: {diff_text(diff)}: the gate fails it")

    # --- pipelined = unpipelined fused -----------------------------------
    res, watch, _, pipe_launches = dispatch_main_run(
        train_cfg, "pipelined", {"saving.save_checkpoint": False,
                                 "saving.saving_dir": str(tmp / "pipe")},
        train_launches)
    text = dispatch_text(watch, "pipelined", pipelined=True)
    print("dispatch: " + gate_runs(
        "pipelined vs unpipelined fused (save_checkpoint false; per-epoch "
        "metrics and final parameters)",
        run_diff((res["train_loss_dict"], final_params(res), None),
                 (train_res["train_loss_dict"], final_params(train_res),
                  None), ref), None) + f"; {text}")

    # --- fused resume to a third epoch = an uninterrupted 3-epoch run ----
    res3, _, _, _ = dispatch_main_run(
        train_cfg, "fused 3 epochs", {"training.epochs": 3,
                                      "saving.saving_dir": str(tmp / "full3")},
        None)
    resumed = ({k: v for k, v in resumed_res["train_loss_dict"].items()},
               *ckpt_state(fused_dir, 2))
    full = ({k: v[2:] for k, v in res3["train_loss_dict"].items()},
            *ckpt_state(tmp / "full3", 2))
    print("dispatch: " + gate_runs(
        "fused resume (2 epochs + 1) vs uninterrupted fused 3 epochs "
        "(epoch 2's metrics, its checkpoint's parameters and optimizer "
        "state)", run_diff(resumed, full, ref), None))

    # --- one train step at 768x512 (the rfft2 path) captured -----------
    cfg_l = large_config()
    data_l = make_dataset(n_subjects=1, slices_per_subject=2, h=768, w=512,
                          n_frames=8, seed=8)
    batch = next(iter(Batcher(JointDataset(
        data_l, dataset_config=cfg_l["datasets"]["train"]), 2)))
    eager, graphed = dispatch_engine(cfg_l, 7), dispatch_engine(cfg_l, 7)
    ref_l = {n: {k: v.detach().cpu().clone()
                 for k, v in m.state_dict().items()}
             for n, m in eager.modules.items()}
    arrays, static = eager.to_device(batch), graphed.to_device(batch)
    g = StepGraph(lambda: graphed._update(static), torch.device("cuda"))
    losses_e, losses_g = [], []
    for _ in range(3):        # eager warm-up, capture + replay, replay
        losses_e.append(eager.train_step(arrays)["total_loss"].item())
        losses_g.append(g()["total_loss"].item())
        graphed._schedules_step()
    torch.cuda.synchronize()
    require(g.graph is not None and g.replays == 2,
            "large: the second and third steps were not replays")

    def large_run(engine, losses):
        return ({"train/total_loss": losses, "val/total_loss": []},
                {n: m.state_dict() for n, m in engine.modules.items()},
                {n: opt.state_dict()["state"]
                 for n, (opt, _) in engine.optimizers.items()})
    print("dispatch: " + gate_runs(
        "768x512 train step captured (warm-up, then capture and replay, "
        "replay) vs 3 eager steps (loss values, parameters, optimizer "
        "state)", run_diff(large_run(graphed, losses_g),
                           large_run(eager, losses_e), ref_l), None))
    del eager, graphed, g, arrays, static

    # --- PrefetchBatcher: the host batches, on the card ------------------
    print("dispatch: " + check_prefetch(train_cfg))

    # --- eval_pipeline: the same predictions ---------------------------
    cfg_s, engine, dataset = build_slice()
    outs = [engine.test({}, {"test": dataset}, trainer_config=dict(
        cfg_s["training"], eval_pipeline=p)) for p in (True, False)]
    (pa, fa, _), (pb, fb, _) = outs
    same = len(pa) == len(pb) == len(dataset) and all(
        a.keys() == b.keys() and all(
            torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))
            if hasattr(a[k], "shape") else a[k] == b[k] for k in a)
        for a, b in zip(pa, pb))
    require(same and fa == fb, "eval_pipeline: predictions differ")
    print(f"dispatch: engine.test with eval_pipeline on and off: "
          f"{len(pa)} slices' predictions torch.equal, metrics equal")

    return pipe_launches


def dispatch_walls(tmp: Path, card: str, train_cfg, train_launches):
    """The 2-epoch ``main.run`` of the train phase, outside the
    deterministic mode, in turns step loop, fused, pipelined, pipelined,
    fused, step loop (``training.host_profile``): each epoch's host wall
    and the checkpoint's share of it, the pipelined cadence, and each
    run's host seconds."""
    modes = {"step loop": {"training.epoch_fuse": False,
                           "training.device_data_cache": False},
             "fused": {},
             "pipelined": {"saving.save_checkpoint": False}}
    walls = {m: [] for m in modes}
    for i, mode in enumerate(("step loop", "fused", "pipelined", "pipelined",
                              "fused", "step loop")):
        _, watch, secs, _ = dispatch_main_run(
            train_cfg, f"walls {mode}", {
                **modes[mode], "training.host_profile": True,
                "saving.saving_dir": str(tmp / f"walls{i}")}, train_launches)
        walls[mode].append(
            f"{epoch_walls(watch, pipelined=mode == 'pipelined')} in "
            f"{secs:.3f} s")
    print(f"dispatch: epoch wall of the 2-epoch main.run (host_profile "
          f"total, checkpoint share; pipelined: the cadence; {card}; turns "
          f"loop, fused, pipelined, pipelined, fused, loop; fused epoch 0 "
          f"warms up and captures): " + "; ".join(
              f"{m} {', '.join(w)}" for m, w in walls.items()))


def run_dispatch_times(card: str, profile_dir=None):
    """Graph vs step loop in turns, on fresh engines, after the earlier
    phases' graphs are released: the flagship train and eval steps and the
    reg train step (with ``profile_dir``, each mode's profiler table)."""
    from cardiax_torch.data.datasets import (BasicRegistrationDataset,
                                             JointDataset)
    from cardiax_torch.data.loader import Batcher
    from cardiax_torch.data.synthetic import (make_dataset,
                                              make_registration_pairs)
    from cardiax_torch.train.graphs import StepGraph
    gc.collect()
    torch.cuda.empty_cache()
    cfg_s, engine, dataset = build_slice()
    t_myo = int(cfg_s["datasets"]["test"]["n_myo_frames_to_use_for_regression"])
    train_ds = JointDataset(make_dataset(
        n_subjects=10, slices_per_subject=3, h=128, w=128, n_frames=t_myo,
        seed=11), dataset_config=cfg_s["datasets"]["train"])
    times = {"train": graph_vs_loop_train(
        "flagship train step", cfg_s, train_ds, t_myo - 1, card,
        "batch 10 at 128^2, T=20", profile_dir)}
    arrays = engine.to_device(next(iter(Batcher(dataset, 10))))
    static = {k: v.clone() for k, v in arrays.items()}
    g_eval = StepGraph(lambda: engine.eval_step(static), torch.device("cuda"))
    times["eval"] = turns_line("flagship eval step",
                               (lambda: engine.eval_step(arrays), 1),
                               (g_eval, 1), card, "batch 10 at 128^2",
                               profile_dir)
    cfg_r = json.loads((ROOT / "configs" / "reg.json").read_text())
    pairs = make_registration_pairs(make_dataset(
        n_subjects=2, slices_per_subject=1, h=128, w=128, n_frames=20,
        seed=9))[:30]
    times["reg"] = graph_vs_loop_train(
        "reg train step", cfg_r, BasicRegistrationDataset(
            pairs, dataset_config=cfg_r["datasets"]["train"]), None, card,
        "batch 10 pairs at 128^2", profile_dir)
    return times


def analytic_config(tmp: Path):
    """configs/joint.json with ``strainmat_net_type: "analytic"`` and only
    its data, split, epochs (2) and saving_dir changed: 160^2 synthetic
    slices, T=20, cropped to 144^2 around the myocardium, resized to 128^2,
    masked out, augmented by 2 sector rotations (interval 10) with one
    translation each (2 variants a slice); train 4 subjects x 3 slices (36
    with the variants), val and test a subject each, augmented slices kept
    in train only, as configs/joint.json keeps them."""
    from cardiax_torch.data.synthetic import make_dataset, save_npy
    cfg = json.loads((ROOT / "configs" / "joint.json").read_text())
    t_myo = int(cfg["datasets"]["train"]["n_myo_frames_to_use_for_regression"])
    npy = tmp / "analytic_slices.npy"
    save_npy(str(npy), make_dataset(n_subjects=6, slices_per_subject=3,
                                    h=160, w=160, n_frames=t_myo, seed=21))
    changes = {
        "networks.joint_register_strainmat.strainmat_net_type": "analytic",
        "training.epochs": 2,
        "saving.saving_dir": str(tmp / "analytic_run"),
        "data.npy_filename": str(npy),
        "data.crop_to_myocardium_size": 144, "data.resize": True,
        "data.resize_size": 128, "data.mask_out": True,
        "data.augment_rotate_times": 2, "data.augment_rotate_interval": 10,
        "data.augment_translate_times_y": 1,
        "data.augment_translate_times_x": 1,
        "data_split.splits.train.exclude_patterns": [".*CT04.*",
                                                     ".*CT05.*"],
        "data_split.splits.val.patterns": [".*CT04.*"],
        "data_split.splits.test.patterns": [".*CT05.*"],
    }
    set_fields(cfg, changes)
    return cfg, changes


def strain_f32_vs_f64(disp, mask0, label) -> str:
    """``strain_matrix_from_displacements`` on the card in f32 against the
    same op on the CPU in float64, within 1e-5 of the output's range. A
    myocardium pixel whose sector differs between the two precisions must
    lie on a sector boundary (an arctan2 tie, within 1e-4 of a sector's
    width): such pixels are counted apart and their sectors left out of the
    error; any other difference fails."""
    from cardiax_torch.ops.strain import (_angles,
                                          strain_matrix_from_displacements)
    n_sec = 126
    out = strain_matrix_from_displacements(disp, mask0, n_sec)
    torch.cuda.synchronize()
    disp64, mask64 = disp.double().cpu(), mask0.double().cpu()
    ref = strain_matrix_from_displacements(disp64, mask64, n_sec)
    pos32 = ((_angles(mask0) + math.pi) / (2 * math.pi) * n_sec).cpu()
    pos64 = (_angles(mask64) + math.pi) / (2 * math.pi) * n_sec
    sec32 = pos32.floor().clamp(0, n_sec - 1).long()
    sec64 = pos64.floor().clamp(0, n_sec - 1).long()
    moved = (sec32 != sec64) & (mask64 > 0)
    frac = pos64 - pos64.round()
    require(bool((frac.abs()[moved] < 1e-4).all()),
            f"{label}: pixels change sector between f32 and f64 away from "
            f"a sector boundary")
    skip = torch.zeros(ref.shape[:2], dtype=torch.bool)
    for b, y, x in moved.nonzero().tolist():
        skip[b, sec32[b, y, x]] = skip[b, sec64[b, y, x]] = True
    err = (out.double().cpu() - ref).abs()[~skip]
    rng = (ref.max() - ref.min()).item()
    worst = err.max().item() / rng
    require(worst <= 1e-5, f"{label}: f32 strain vs float64 "
            f"{err.max().item():.3e} = {worst:.3e} of the range {rng:.4g}")
    return (f"strain op f32 on the card vs float64 on the CPU over "
            f"{tuple(ref.shape)}: max |d| {err.max().item():.3e} = "
            f"{worst:.3e} of the range {rng:.4g} (tol 1e-5); "
            f"{int(moved.sum())} boundary-tie pixels in "
            f"{int(skip.sum())} sectors reported apart")


def analytic_vs_flagship(card, dataset, cfg_a, cfg_r, n_pairs,
                         profile_dir=None) -> str:
    """The analytic and the ResNet3D flagship train steps over the same
    resident dataset, from seeded weights: peak memory of each mode, host
    time a step in turns (analytic loop, flagship loop, flagship loop,
    analytic loop; then the graphs likewise) and each mode's device busy
    time (profiler; with ``profile_dir`` the analytic loop step's table)."""
    from cardiax_torch.data.loader import Batcher, DeviceBatcher
    from cardiax_torch.train.graphs import EpochRunner
    bs = int(cfg_a["training"]["batch_size"])
    fns = {}
    for name, cfg in (("analytic", cfg_a), ("ResNet3D", cfg_r)):
        loop_eng = dispatch_engine(cfg, n_pairs)
        arrays = loop_eng.to_device(next(iter(Batcher(dataset, bs))))
        graph_eng = dispatch_engine(cfg, n_pairs)
        loader = DeviceBatcher(dataset, bs, shuffle=True, seed=3,
                               device=torch.device("cuda"))
        runner = EpochRunner(loader, graph_eng._update,
                             after_step=graph_eng._schedules_step)
        fns[name] = {
            "loop": (lambda e=loop_eng, a=arrays: e.train_step(a), 1),
            "graph": (lambda r=runner, ld=loader: r(*ld.epoch_plan()),
                      len(loader))}
    mem = {(n, w): memory_gb(fns[n][w][0]) for n in fns for w in ("loop",
                                                                  "graph")}
    host = {k: [] for k in mem}
    for w in ("loop", "graph"):
        for n in ("analytic", "ResNet3D", "ResNet3D", "analytic"):
            fn, steps = fns[n][w]
            host[(n, w)].append(
                timed_ms(fn, steps, max(1, math.ceil(10 / steps))))
    parts = []
    for (n, w), hs in host.items():
        fn, steps = fns[n][w]
        busy, prof = profile_steps(fn)
        busy = None if busy is None else busy / steps
        if profile_dir and (n, w) == ("analytic", "loop"):
            write_profile(prof, Path(profile_dir), "analytic_train")
        h = sum(hs) / len(hs)
        idle = "not measured" if busy is None else f"{1 - busy / h:.1%}"
        parts.append(
            f"{n} {w} host {', '.join(f'{x:.3f}' for x in hs)} ms/step, "
            f"device busy {'not measured' if busy is None else f'{busy:.3f} ms'}"
            f"/step, idle {idle}, peak allocated {mem[(n, w)][0]:.3f} GB, "
            f"reserved +{mem[(n, w)][1]:.3f} GB")
    return (f"analytic vs ResNet3D train step (batch {bs} at 128^2, T=20; "
            f"{card}; turns analytic, ResNet3D, ResNet3D, analytic, loop "
            f"then graph): " + "; ".join(parts))


def run_analytic(tmp: Path, card: str, profile_dir=None):
    """The analytic strain path at full width: ``load_data`` with the
    preprocessing chain and augmentation through the native engine (host
    time a slice), ``main.run`` of configs/joint.json with
    ``strainmat_net_type: "analytic"`` for 2 epochs under JAX's ``auto``
    dispatch (CUDA graphs; exact K1-K4 launches, finite losses each epoch,
    128^2 frames), one train step kernel vs plain, the strain op in f32 on
    the card against float64, and the analytic step beside the ResNet3D
    flagship step. Returns the launches of ``main.run``."""
    from cardiax_torch import main as port_main
    from cardiax_torch.data import load_data
    from cardiax_torch.data.datasets import JointDataset
    from cardiax_torch.data.loader import Batcher
    from cardiax_torch.native import native_available
    require(native_available(), "analytic: the native data engine did not "
            "build")
    cfg, changes = analytic_config(tmp)
    print(f"analytic: configs/joint.json with {json.dumps(changes)}")
    t0 = time.perf_counter()
    data = load_data(copy.deepcopy(cfg["data"]), cfg)
    load_s = time.perf_counter() - t0
    n_aug = sum(d["augmented"] for d in data)
    shapes = {d["cine_lv_myo_masks"].shape for d in data}
    require(len(data) == 54 and n_aug == 36 and shapes == {(128, 128, 20)},
            f"analytic: load_data gave {len(data)} slices ({n_aug} "
            f"augmented) of {shapes}")
    print(f"analytic: load_data of 18 slices of 160^2 x 20 (native engine): "
          f"{len(data)} slices ({n_aug} augmented), cropped to 144^2, resized"
          f" to 128^2, masked out, in {load_s * 1e3:.3f} ms host = "
          f"{load_s / 18 * 1e3:.3f} ms an input slice, "
          f"{load_s / len(data) * 1e3:.3f} ms an output slice")

    epochs = cfg["training"]["epochs"]
    batch_size = int(cfg["training"]["batch_size"])
    n_steps = n_euler_steps(cfg)
    vis_every = max(1, int(float(cfg["others"]["wandb_visualize_interval"])
                           * epochs))
    n_figs = len(range(0, epochs, vis_every))
    zero_counts()
    t0 = time.perf_counter()
    with watched_main_run() as watch:
        res = port_main.run(copy.deepcopy(cfg))
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = named_counts()
    train_steps = epochs * math.ceil(36 / batch_size)
    eval_batches = epochs + n_figs + 2
    expect = {"mc_warp_fwd": train_steps + eval_batches,
              "epdiff_step_fwd": n_steps * (train_steps + eval_batches),
              "epdiff_step_bwd": n_steps * train_steps,
              "mc_warp_disp_bwd": train_steps, "mc_warp_fused_bwd": 0,
              "epdiff_step_solve_fwd": 0, "epdiff_step_solve_bwd": 0}
    require(launches == expect, f"analytic launches {launches} != {expect}")
    hist = res["train_loss_dict"]
    for key in ("train/total_loss", "val/total_loss"):
        require(len(hist[key]) == epochs
                and all(math.isfinite(v) for v in hist[key]),
                f"analytic {key} per epoch: {hist[key]}")
    perf = {k: v for t in ("val", "test")
            for k, v in res[f"{t}_performance"].items()}
    require(all(math.isfinite(v) for v in perf.values()),
            f"analytic: non-finite metric: {perf}")
    eng, train_loader, val_loader = watch.engines[0]
    frames = {tuple(ld._data["cine_myo_mask"].shape)
              for ld in (train_loader, val_loader)}
    require(frames == {(36, 1, 20, 128, 128), (3, 1, 20, 128, 128)},
            f"analytic: resident frames {frames}")
    require(eng.modules["joint_register_strainmat"].strain_head is None,
            "analytic: the network has a strain head")
    print(f"analytic: main.run {epochs} epochs x {train_steps // epochs} "
          f"train steps (last batch padded) + {eval_batches} eval batches in "
          f"{secs:.2f} s; resident frames {sorted(frames)}; total_loss per "
          f"epoch train {[round(v, 6) for v in hist['train/total_loss']]}, "
          f"val {[round(v, 6) for v in hist['val/total_loss']]}; "
          f"{save_text(watch.saves)}; launches {launches}; "
          f"{dispatch_text(watch, 'analytic', pipelined=False)}")

    # one train step kernel vs plain, on the preprocessed slices
    train = [d for d in data if "CT04" not in d["subject_id"]
             and "CT05" not in d["subject_id"]]
    ds = JointDataset(train, dataset_config=cfg["datasets"]["train"])
    batch = next(iter(Batcher(ds, batch_size)))
    fresh_engine, arrays = kernel_vs_plain_step(cfg, batch, "analytic step")

    # the strain op on the step's displacements
    engine = fresh_engine()
    with torch.no_grad():
        _, preds = engine.eval_step(arrays)
    disp = preds["displacement"].float().transpose(1, 2).contiguous()
    require(disp.abs().max().item() > 0.05,
            "analytic: the momentum head moved nothing")
    mask0 = arrays["cine_myo_mask"][:, 0, 0]
    print(f"analytic: {strain_f32_vs_f64(disp, mask0, 'analytic')}; "
          f"max|u_inv| {disp.abs().max().item():.3f} px")
    del engine, fresh_engine, arrays, preds, mask0
    gc.collect()
    torch.cuda.empty_cache()

    cfg_r = json.loads((ROOT / "configs" / "joint.json").read_text())
    t_myo = int(cfg_r["datasets"]["train"]["n_myo_frames_to_use_for_regression"])
    print(f"analytic: "
          f"{analytic_vs_flagship(card, ds, cfg, cfg_r, t_myo - 1, profile_dir)}")
    return launches


def run_kfold_phase(tmp: Path, card: str):
    """``cardiax_torch.kfold.run_kfold`` on configs/joint.json as written
    (ResNet3D) but for data, epochs (1) and saving_dir: 2 folds of 2
    synthetic subjects each (3 slices a subject, 128^2, T=20), the other 4
    subjects train. Gates: finite ``fold{i}/`` metrics and their average,
    and each fold's exact K1-K4 launches. Returns the launches of both
    folds."""
    from cardiax_torch import kfold
    from cardiax_torch.data.synthetic import make_dataset, save_npy
    cfg = json.loads((ROOT / "configs" / "joint.json").read_text())
    t_myo = int(cfg["datasets"]["train"]["n_myo_frames_to_use_for_regression"])
    npy = tmp / "kfold_slices.npy"
    save_npy(str(npy), make_dataset(n_subjects=8, slices_per_subject=3,
                                    h=128, w=128, n_frames=t_myo, seed=23))
    set_fields(cfg, {"training.epochs": 1, "data.npy_filename": str(npy),
                     "saving.saving_dir": str(tmp / "kfold_run")})
    folds = [[".*CT00.*", ".*CT01.*"], [".*CT02.*", ".*CT03.*"]]
    marks = []
    build = kfold.build_trainer

    def marked_build(*args, **kwargs):
        torch.cuda.synchronize()
        marks.append(named_counts())
        return build(*args, **kwargs)

    zero_counts()
    t0 = time.perf_counter()
    kfold.build_trainer = marked_build
    try:
        out = kfold.run_kfold(cfg, folds)
        torch.cuda.synchronize()
    finally:
        kfold.build_trainer = build
    secs = time.perf_counter() - t0
    marks.append(named_counts())
    n_steps = n_euler_steps(cfg)
    bs = int(cfg["training"]["batch_size"])
    train_steps = math.ceil(12 / bs)
    eval_batches = 1 + 1 + 2          # val, the figure's val batch, val+test
    expect = {"mc_warp_fwd": train_steps + eval_batches,
              "epdiff_step_fwd": n_steps * (train_steps + eval_batches),
              "epdiff_step_bwd": n_steps * train_steps,
              "mc_warp_disp_bwd": train_steps, "mc_warp_fused_bwd": 0,
              "epdiff_step_solve_fwd": 0, "epdiff_step_solve_bwd": 0}
    require(len(marks) == 3, f"kfold: {len(marks) - 1} folds trained")
    for i in range(2):
        got = {k: marks[i + 1][k] - marks[i][k] for k in expect}
        require(got == expect, f"kfold fold {i} launches {got} != {expect}")
    require(len(out["folds"]) == 2, "kfold: not 2 folds")
    for r in out["folds"]:
        perf = r["performance"]
        require(perf and all(k.startswith(f"fold{r['fold']}/") and
                             math.isfinite(v) for k, v in perf.items()),
                f"kfold fold {r['fold']}: metrics {perf}")
    avg = out["average"]
    key = "average/final-test/sector_error"
    require(key in avg and all(math.isfinite(v) for v in avg.values()),
            f"kfold: average {avg}")
    launches = {k: marks[2][k] - marks[0][k] for k in expect}
    per_fold = [r["performance"][f"fold{r['fold']}/final-test/sector_error"]
                for r in out["folds"]]
    print(f"kfold: run_kfold on configs/joint.json (ResNet3D), 2 folds of 2 "
          f"subjects x 3 slices, train 12 slices, 1 epoch each, in "
          f"{secs:.2f} s ({card}): per fold launches {expect}; "
          f"{len(avg)} averaged metrics, {key} {avg[key]:.4f} (folds "
          f"{', '.join(f'{v:.4f}' for v in per_fold)})")
    return launches


# the fresh process of the export phase: it imports only ``cardiax_torch``,
# loads the three programs, calls each once on the held batch with the
# launch counts from 0, and writes the outputs back
EXPORT_CHILD = r"""
import json, sys, time
import torch
from cardiax_torch.io.export import load_exported
from cardiax_torch.ops import counters
run_dir = sys.argv[1]
args = torch.load(run_dir + "/export_args.pt")
outs, launches, load_s = {}, {}, {}
for name, path in json.loads(sys.argv[2]).items():
    t0 = time.perf_counter()
    program = load_exported(path)
    load_s[name] = time.perf_counter() - t0
    counters.reset()
    outs[name] = program.call(*args[name])
    torch.cuda.synchronize()
    launches[name] = counters.snapshot()
torch.save(outs, run_dir + "/export_out.pt")
imported = sorted({m.split(".")[0] for m in sys.modules} & {"jax", "flax", "cardiax"})
print(json.dumps({"launches": launches, "load_s": load_s, "imported": imported}))
"""

# the flagship's outputs computed in float32 end to end, and those that pass
# through its bf16 conv trunks (the strain head, NetStrainMat2LMA)
F32_OUTPUTS = ("deformed_source", "velocity", "momentum", "displacement")


def range_err(got, want) -> float:
    """max |got - want| over the range of want."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max()
                 / (want.max() - want.min()).clamp_min(1e-12))


def gate_outputs(label, got, want) -> str:
    """The float32 registration outputs within 1e-5 of each output's range,
    the bf16-trunk ones within the eval step's 1.9e-2. Returns the text."""
    require(set(got) == set(want), f"{label}: outputs {sorted(got)} != "
                                   f"{sorted(want)}")
    errs = {}
    for k in sorted(want):
        tol = 1e-5 if k in F32_OUTPUTS else 1.9e-2
        errs[k] = range_err(got[k], want[k])
        require(torch.isfinite(got[k]).all() and errs[k] <= tol,
                f"{label}: {k} off by {errs[k]:.3e} of its range (> {tol})")
    return ", ".join(f"{k} {v:.2e}" for k, v in errs.items())


def export_turns(label, eager, exported, card) -> str:
    """Host ms of one call in turns eager, exported, exported, eager (10
    synchronised calls a turn) and the device busy ms of a call from the
    profiler (3 calls), for each."""
    fns = {"eager": eager, "exported": exported}
    host = {"eager": [], "exported": []}
    for w in ("eager", "exported", "exported", "eager"):
        host[w].append(timed_ms(fns[w], 1, 10))
    parts = []
    for w in ("eager", "exported"):
        busy = profile_steps(fns[w])[0]
        parts.append(f"{w} host {', '.join(f'{x:.3f}' for x in host[w])} "
                     f"ms, device busy "
                     f"{'not measured' if busy is None else f'{busy:.3f} ms'}")
    return (f"{label} one call ({card}; turns eager, exported, exported, "
            f"eager): " + "; ".join(parts))


def ellipsoid_mesh(n_theta=16, n_z=8, rx=20.0, ry=20.0, rz=30.0):
    """The closed ellipsoid that ``tests/test_plot.py`` stands in for a
    heart STL."""
    tris = []
    zs = np.linspace(-rz, rz, n_z)
    for zi in range(n_z - 1):
        r0 = np.sqrt(max(1e-6, 1 - (zs[zi] / rz) ** 2))
        r1 = np.sqrt(max(1e-6, 1 - (zs[zi + 1] / rz) ** 2))
        for ti in range(n_theta):
            t0 = 2 * np.pi * ti / n_theta
            t1 = 2 * np.pi * (ti + 1) / n_theta
            p00 = [rx * r0 * np.cos(t0), ry * r0 * np.sin(t0), zs[zi]]
            p01 = [rx * r0 * np.cos(t1), ry * r0 * np.sin(t1), zs[zi]]
            p10 = [rx * r1 * np.cos(t0), ry * r1 * np.sin(t0), zs[zi + 1]]
            p11 = [rx * r1 * np.cos(t1), ry * r1 * np.sin(t1), zs[zi + 1]]
            tris.append([p00, p01, p10])
            tris.append([p01, p11, p10])
    return np.asarray(tris, np.float32)


def run_export(tmp: Path, card: str):
    """``main.run`` on configs/joint.json at full width, trained for 2
    epochs (the momentum head is zero at init: an untrained export would
    hold a zero displacement) with ``saving.save_model_method: "jit"``:
    ``model-joint_register_strainmat.pt2`` and ``model-LMA.pt2`` beside
    the ``.pt`` state dicts; with ``shooting._FUSED_SOLVE`` the joint
    network exported once more. A fresh process that imports only
    ``cardiax_torch`` loads the three programs and calls each on a held
    test batch. Gates: the outputs against the eager modules loaded from
    the ``.pt`` files (``gate_outputs``), the launches of each call (the
    joint program 5 K2 + 1 K1, the LMA program none, the fused-solve one 5
    K6 and no K2; no backward kernel), a ``model_zip_state_dict`` export
    holding ``csrc/*.cu`` and ``params.pt`` equal to the state dict, and
    the 3D activation map from the run's ``val_pred.npy``. Returns the
    launches of the joint and LMA calls, and of the fused-solve call."""
    from cardiax_torch import main as port_main
    from cardiax_torch.data.synthetic import make_dataset, save_npy
    from cardiax_torch.io import export as texport
    from cardiax_torch.data.datasets import JointDataset
    from cardiax_torch.data.loader import Batcher
    from cardiax_torch.models import build_model
    from cardiax_torch.ops import counters
    from cardiax_torch.ops import shooting as sh
    from cardiax_torch.plot.activation_map import (
        build_3D_activation_map_multiple, generate_3D_activation_map)
    from cardiax_torch.train.schemes.joint_reg_strainmat_lma import \
        _lagrangian_pairs
    cfg = json.loads((ROOT / "configs" / "joint.json").read_text())
    t_myo = int(cfg["datasets"]["train"]["n_myo_frames_to_use_for_regression"])
    npy = tmp / "export_slices.npy"
    save_npy(str(npy), make_dataset(n_subjects=6, slices_per_subject=5,
                                    h=128, w=128, n_frames=t_myo, seed=29))
    run_dir = tmp / "export_run"
    changes = {
        "training.epochs": 2,
        "saving.saving_dir": str(run_dir),
        "saving.save_final_model": True,
        "saving.save_model_method": "jit",
        "data.npy_filename": str(npy),
        "data_split": {"method": "by_count", "splits": {
            "train": {"count": 20}, "val": {"count": 5},
            "test": {"count": 5}}},
    }
    set_fields(cfg, changes)
    print(f"export: configs/joint.json with {json.dumps(changes)}")

    # main.run, each save_model call timed
    exports = []
    save_model = texport.save_model

    def timed_save_model(bundle, stem, method="state_dict", **kwargs):
        t0 = time.perf_counter()
        out = save_model(bundle, stem, method, **kwargs)
        exports.append((Path(out).name, time.perf_counter() - t0,
                        Path(out).stat().st_size))
        return out

    texport.save_model = timed_save_model
    try:
        t0 = time.perf_counter()
        port_main.run(copy.deepcopy(cfg))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        texport.save_model = save_model
    programs = {"joint": run_dir / "model-joint_register_strainmat.pt2",
                "LMA": run_dir / "model-LMA.pt2"}
    require(all(p.is_file() for p in programs.values()),
            f"export: main.run wrote {sorted(x.name for x in run_dir.iterdir())}")

    # the eager modules from the state dicts, and a held test batch
    n_pairs = t_myo - 1
    eager = {}
    for name, mc in cfg["networks"].items():
        bundle = build_model(mc, n_pairs=n_pairs)
        bundle.module.load_state_dict(torch.load(
            run_dir / f"model-{name}.pt", weights_only=True))
        eager[name] = bundle.module.cuda().eval()
    held = JointDataset(make_dataset(n_subjects=2, slices_per_subject=5,
                                     h=128, w=128, n_frames=t_myo, seed=31),
                        dataset_config=cfg["datasets"]["test"])
    batch = next(iter(Batcher(held, 10)))
    vol = torch.from_numpy(batch["cine_myo_mask"]).cuda()   # (10,1,T,H,W)
    src, tar = _lagrangian_pairs(vol)
    with torch.no_grad():
        want_joint = eager["joint_register_strainmat"](src, tar)
        sm = want_joint["strain_matrix"].contiguous()
        want = {"joint": want_joint, "LMA": eager["LMA"](sm)}
    require(float(want_joint["displacement"].abs().max()) > 0,
            "export: the trained network's displacement is zero")
    args = {"joint": (src, tar), "LMA": (sm,)}

    # the fused-solve export of the joint network, and its eager output
    saved_flag = sh._FUSED_SOLVE
    sh._FUSED_SOLVE = True
    try:
        t0 = time.perf_counter()
        programs["solve"] = texport.save_model(
            types.SimpleNamespace(module=eager["joint_register_strainmat"]),
            run_dir / "export_solve" / "model-joint_register_strainmat",
            "jit", example_args=(src, tar))
        solve_export_s = time.perf_counter() - t0
        zero_counts()
        with torch.no_grad():
            want["solve"] = eager["joint_register_strainmat"](src, tar)
        torch.cuda.synchronize()
        eager_solve_launches = named_counts()
    finally:
        sh._FUSED_SOLVE = saved_flag
    args["solve"] = (src, tar)
    torch.save(args, run_dir / "export_args.pt")

    proc = subprocess.run(
        [sys.executable, "-c", EXPORT_CHILD, str(run_dir),
         json.dumps({k: str(v) for k, v in programs.items()})],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0,
            f"export: the fresh process failed:\n{proc.stderr[-4000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    require(not child["imported"],
            f"export: the fresh process imported {child['imported']}")
    got = torch.load(run_dir / "export_out.pt")
    errs = {k: gate_outputs(f"export {k}", got[k], want[k]) for k in want}

    n_steps = n_euler_steps(cfg)
    none = dict.fromkeys(counters.KERNELS, 0)
    expect = {"joint": {**none, "epdiff_step_fwd": n_steps, "mc_warp_fwd": 1},
              "LMA": none,
              "solve": {**none, "epdiff_step_solve_fwd": n_steps,
                        "mc_warp_fwd": 1}}
    for k, e in expect.items():
        require(child["launches"][k] == e,
                f"export {k}: launches {child['launches'][k]} != {e}")
    require(eager_solve_launches == expect["solve"],
            f"export: the eager solve path launched {eager_solve_launches}")

    # the zip: the sources, the kernels' among them, and the state dict
    zipped = texport.save_model(
        types.SimpleNamespace(module=eager["LMA"]), run_dir / "zipped",
        "model_zip_state_dict")
    import io
    import zipfile
    with zipfile.ZipFile(zipped) as z:
        names = set(z.namelist())
        params = torch.load(io.BytesIO(z.read("params.pt")),
                            weights_only=True)
    cu = sorted(n for n in names if n.startswith("cardiax_torch/csrc/")
                and n.endswith(".cu"))
    require({"cardiax_torch/csrc/mc_warp.cu",
             "cardiax_torch/csrc/epdiff_step.cu"} <= set(cu),
            f"export: the zip holds {cu}")
    state = eager["LMA"].state_dict()
    require(params.keys() == state.keys()
            and all(torch.equal(params[k], state[k].cpu()) for k in state),
            "export: the zip's params.pt is not the state dict")

    # the 3D activation map from the card's TOS predictions
    preds = list(np.load(run_dir / "val_pred.npy", allow_pickle=True))
    maps = build_3D_activation_map_multiple(preds, ellipsoid_mesh())
    require(maps and all(
        np.isfinite(m["face_colors"]).all()
        and m["face_colors"].min() >= 0 and m["face_colors"].max() <= 1
        for m in maps.values()), "export: activation map face colours")
    by_subject = {}
    for p in preds:
        by_subject.setdefault(str(p["subject_id"]), []).append(
            np.asarray(p["TOS_pred"]).ravel())
    surfaces = {sid: generate_3D_activation_map(rows, list(range(len(rows))))
                for sid, rows in by_subject.items()}
    require(all(np.isfinite(s["tos"]).all() and s["tos"].min() >= 17.0
                for s in surfaces.values()), "export: TOS surface")

    # one call, exported against eager, in turns
    loaded = {k: texport.load_exported(v) for k, v in programs.items()}
    turns = []
    for k, module in (("joint", eager["joint_register_strainmat"]),
                      ("LMA", eager["LMA"])):
        def run_eager(module=module, a=args[k]):
            with torch.no_grad():
                module(*a)
        turns.append(export_turns(
            f"export {k}", run_eager,
            lambda p=loaded[k], a=args[k]: p.call(*a), card))
    print(f"export: main.run 2 epochs x 2 train steps, then the val and "
          f"test predictions and the saves, in {secs:.2f} s ({card}); "
          f"save_model calls {', '.join(f'{n} {t:.3f} s {b / 1e6:.3f} MB' for n, t, b in exports)}; "
          f"fused-solve export {solve_export_s:.3f} s "
          f"{programs['solve'].stat().st_size / 1e6:.3f} MB; the fresh "
          f"process loaded {', '.join(f'{k} in {v:.3f} s' for k, v in child['load_s'].items())} "
          f"and launched {child['launches']}; outputs against the eager "
          f"modules (of the range): {'; '.join(f'{k}: {v}' for k, v in errs.items())}; "
          f"zip {zipped.stat().st_size / 1e6:.3f} MB with {len(names)} files, "
          f"{cu}; activation maps of {len(maps)} subjects "
          f"({sum(len(r) for r in by_subject.values())} val slices, "
          f"{len(next(iter(maps.values()))['face_colors'])} faces)")
    for line in turns:
        print(line)
    add = {k: child["launches"]["joint"][k] + child["launches"]["LMA"][k]
           for k in counters.KERNELS}
    return add, child["launches"]["solve"]


# ---- dp: data parallel (cardiax_torch.parallel) ------------------------------ #

DP_STEPS = 3            # the flagship's train steps of the dp2/dp_cards ranks
DP_TIMEOUT_S = 300      # a rank that has not ended by then is killed


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def counted_all_reduce():
    """Around a run: every ``torch.distributed.all_reduce`` call and its
    bytes (``calls``, ``bytes``), and on each ``StepGraph`` the calls and
    bytes its capture holds (``graph.all_reduces``)."""
    import torch.distributed as dist
    from cardiax_torch.train.graphs import StepGraph
    real, capture = dist.all_reduce, StepGraph._capture
    rec = types.SimpleNamespace(calls=0, bytes=0)

    def counting(t, *args, **kwargs):
        rec.calls += 1
        rec.bytes += t.numel() * t.element_size()
        return real(t, *args, **kwargs)

    def recorded_capture(self):
        calls, nbytes = rec.calls, rec.bytes
        capture(self)
        self.all_reduces = (rec.calls - calls, rec.bytes - nbytes)

    dist.all_reduce, StepGraph._capture = counting, recorded_capture
    try:
        yield rec
    finally:
        dist.all_reduce, StepGraph._capture = real, capture


def run_dp1(tmp: Path, train_cfg, train_res, train_launches):
    """``main.run`` of the train phase's config with ``parallel.mesh_shape:
    "1"`` over a world-1 NCCL process group: the fused epoch captured with
    the NCCL all-reduces inside, ``torch.equal`` (metrics, the epoch-1
    checkpoint's parameters and optimizer state) to the train phase's run
    without a mesh (the scale is exactly 1, the all-reduce a copy), with
    its exact launches under replay. Runs under ``device.deterministic``."""
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        with counted_all_reduce() as rec:
            res, watch, secs, launches = dispatch_main_run(
                train_cfg, "dp1", {"parallel": {"mesh_shape": "1"},
                                   "saving.saving_dir": str(tmp / "dp1")},
                train_launches)
        eng = watch.engines[0][0]
        require(eng._dp and eng.mesh.backend == "nccl"
                and eng.mesh.shape == {"data": 1},
                f"dp1: the engine is not data parallel over NCCL: "
                f"{eng.mesh}")
        text = dispatch_text(watch, "dp1", pipelined=False)
        per_graph = {("eval" if for_eval else "train"): r.graph.all_reduces
                     for (_, for_eval), r in eng._runners.items()}
        require(per_graph.get("train", (0, 0))[0] > 0,
                f"dp1: the captured train step holds no all-reduce: "
                f"{per_graph}")
    finally:
        dist.destroy_process_group()

    def run_of(r, run_dir):
        params, opt = ckpt_state(run_dir, 1)
        return r["train_loss_dict"], params, opt

    diff = run_diff(run_of(res, tmp / "dp1"),
                    run_of(train_res, Path(train_cfg["saving"]["saving_dir"])),
                    watch.initial[0])
    gate = gate_runs("dp1 (mesh (1,) over NCCL) vs the train phase's run "
                     "without a mesh", diff, None)
    print(f"dp: {gate}; main.run in {secs:.2f} s; {text}; captured "
          f"all-reduces a step: "
          + ", ".join(f"{k} {n} ({b} bytes)" for k, (n, b)
                      in sorted(per_graph.items()))
          + f"; {rec.calls} all-reduce calls in the run, {rec.bytes} bytes; "
          f"launches {launches}")
    return launches


def dp_data(cfg):
    """The dp ranks' data: 3 global batches of 10 from 30 synthetic 128^2
    slices (T=20), and a 15-slice test set (batches of 10 and 5 + 5
    padding)."""
    from cardiax_torch.data.datasets import JointDataset
    from cardiax_torch.data.loader import Batcher
    from cardiax_torch.data.synthetic import make_dataset
    ds_cfg = cfg["datasets"]["train"]
    t_myo = int(ds_cfg["n_myo_frames_to_use_for_regression"])
    train = JointDataset(make_dataset(n_subjects=10, slices_per_subject=3,
                                      h=128, w=128, n_frames=t_myo, seed=8),
                         dataset_config=ds_cfg)
    test = JointDataset(make_dataset(n_subjects=5, slices_per_subject=3,
                                     h=128, w=128, n_frames=t_myo, seed=9),
                        dataset_config=cfg["datasets"]["test"])
    batches = list(Batcher(train, int(cfg["training"]["batch_size"])))
    require(len(batches) == DP_STEPS, f"dp: {len(batches)} batches")
    return batches, test


def shard_steps(engine, batches, shards: int):
    """The ranks' arithmetic in one process, without a collective: each
    train step runs backward on each of ``shards`` row blocks of the batch
    apart and sums their values and gradients, each weighted by its share
    of the batch's real rows (the displacement max: the max), then steps
    the optimizers. Returns each step's values and the first step's
    gradients (``grads_of``'s names)."""
    params = {f"{name}.{k}": p for name, m in engine.modules.items()
              for k, p in m.named_parameters() if p.requires_grad}
    values_out, first = [], None
    for batch in batches:
        rows, total = len(batch["sample_mask"]), batch["sample_mask"].sum()
        values, grads = {}, {}
        for i in range(shards):
            part = {k: v[i * rows // shards:(i + 1) * rows // shards]
                    for k, v in batch.items() if isinstance(v, np.ndarray)}
            w = float(part["sample_mask"].sum() / total)
            for k, v in engine.backward(engine.to_device(part)).items():
                values[k] = max(values.get(k, 0.0), float(v)) \
                    if k == "max_abs_displacement" \
                    else values.get(k, 0.0) + w * float(v)
            for k, p in params.items():
                grads[k] = grads.get(k, 0) + w * p.grad
        for k, p in params.items():
            p.grad = grads[k]
        for opt, _ in engine.optimizers.values():
            opt.step()
        engine._schedules_step()
        values_out.append(values)
        first = first or {k: g.cpu() for k, g in grads.items()}
    return values_out, first


def dp_engine(mesh, dev):
    """The flagship at full width, seeded random weights, on ``mesh``."""
    from cardiax_torch.train import build_trainer
    cfg = json.loads((ROOT / "configs" / "joint.json").read_text())
    n_pairs = int(cfg["datasets"]["train"]
                  ["n_myo_frames_to_use_for_regression"]) - 1
    engine = build_trainer(cfg["training"], dev, cfg, mesh=mesh)
    engine.setup(random_nets(cfg, n_pairs, seed=1), None, DP_STEPS)
    return engine


def dp_work(mesh, dev):
    """One rank's (or, ``mesh`` None, the one-rank reference's) work: the
    flagship at full width with seeded random weights, 3 train steps on
    the global batches (the step loop; a ``StepGraph`` of the step where
    the collectives are NCCL's), ``engine.test`` on the test set, and on a
    gloo mesh ``epoch_fuse: true``, which must raise."""
    from cardiax_torch.train import build_trainer
    from cardiax_torch.train.graphs import StepGraph
    engine = dp_engine(mesh, dev)
    cfg = engine.full_config
    batches, test = dp_data(cfg)
    static: dict = {}
    graph = StepGraph(lambda: engine._update(static), engine.device) \
        if mesh is not None and mesh.backend == "nccl" else None

    def step(arrays):
        if graph is None:
            return engine.train_step(arrays)
        if not static:
            static.update({k: v.clone() for k, v in arrays.items()})
        for k, v in arrays.items():
            static[k].copy_(v)
        values = graph()
        engine._schedules_step()
        return values

    out = {"values": [], "host_ms": [], "device_ms": [],
           "graph": graph is not None}
    zero_counts()
    for i, batch in enumerate(batches):
        arrays = engine.to_device(batch)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        values = step(arrays)
        end.record()
        torch.cuda.synchronize()
        out["host_ms"].append((time.perf_counter() - t0) * 1e3)
        out["device_ms"].append(start.elapsed_time(end))
        out["values"].append({k: float(v) for k, v in values.items()})
        if i == 0:
            out["grads"] = {k: g.cpu() for k, g in grads_of(engine).items()}
    out["step_launches"] = named_counts()
    out["params"] = {n: {k: v.detach().cpu().clone()
                         for k, v in m.state_dict().items()}
                     for n, m in engine.modules.items()}
    if mesh is not None:
        # the gradient all-reduce alone (it sums the held gradients again:
        # they are not read after this)
        out["all_reduce_bytes"] = sum(
            p.grad.numel() * p.grad.element_size()
            for m in engine.modules.values() for p in m.parameters()
            if p.grad is not None)
        ms = []
        for _ in range(5):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            engine._reduce_gradients()
            end.record()
            torch.cuda.synchronize()
            ms.append(((time.perf_counter() - t0) * 1e3,
                       start.elapsed_time(end)))
        out["all_reduce_ms"] = ms
    zero_counts()
    preds, _, _ = engine.test({}, {"test": test})
    torch.cuda.synchronize()
    out["test_launches"] = named_counts()
    out["test_tos"] = np.stack([p["TOS_pred"] for p in preds])
    if mesh is not None and mesh.backend != "nccl":
        fuse_cfg = copy.deepcopy(cfg)
        fuse_cfg["training"].update(epoch_fuse=True, epochs=1)
        fuse_cfg["saving"] = {}
        fused = build_trainer(fuse_cfg["training"], dev, fuse_cfg, mesh=mesh)
        try:
            n_pairs = int(cfg["datasets"]["train"]
                          ["n_myo_frames_to_use_for_regression"]) - 1
            fused.train(random_nets(cfg, n_pairs, seed=1), {"train": test})
            out["fuse_error"] = None
        except NotImplementedError as e:
            out["fuse_error"] = str(e)
    return out


def dp_rank_main(args) -> int:
    """A rank of the dp2/dp_cards phases (``chip_smoke.py`` started again
    with the hidden ``--dp-*`` arguments): joins the process group, runs
    ``dp_work`` and saves what it saw for the parent."""
    import torch.distributed as dist
    from cardiax_torch.device import set_numerics
    from cardiax_torch.parallel import get_mesh
    set_numerics()
    devs = [torch.device("cuda", 0 if args.dp_one_card else r)
            for r in range(args.dp_world)]
    torch.cuda.set_device(devs[args.dp_rank])
    dist.init_process_group(args.dp_backend,
                            init_method=f"tcp://127.0.0.1:{args.dp_port}",
                            world_size=args.dp_world, rank=args.dp_rank)
    try:
        mesh = get_mesh(devices=devs)
        out = dp_work(mesh, devs[args.dp_rank])
        out["backend"], out["device"] = mesh.backend, str(mesh.device)
        torch.save(out, Path(args.dp_out) / f"rank{args.dp_rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def run_dp_ranks(tmp: Path, card: str, label: str, world: int,
                 backend: str, one_card: bool):
    """``world`` ranks of ``dp_work`` (rank processes, their output in
    ``tmp``) against two references here. One process summing the same
    shards (``shard_steps``: the ranks' arithmetic without a collective):
    the first step's values and all-reduced gradients within 1e-5
    relative, the later steps' values within 1e-4 (Adam carries the first
    step's rounding into the weights). One rank on the full batch (``dp_work`` without a
    mesh): the loss values within 1e-3 relative step by step
    (``max_abs_displacement`` at the first step only: a max, not a loss),
    the gradients within 5e-2 relative L2 a tensor (the kernel-vs-plain
    step gate), or, where one process summing the shards departs from the
    full batch as far (bf16 trunks at batch 5 round otherwise than at 10),
    within that departure plus the shard tolerance. Also: the ranks' parameters
    ``torch.equal`` after the steps, each rank's exact launches,
    ``engine.test``'s gathered predictions within 1.9e-2 of their range of
    the reference's (the eval gate), equal on every rank, and on gloo
    ``epoch_fuse: true`` raising with the backend's reason. Returns rank
    0's launches."""
    out_dir = tmp / label
    out_dir.mkdir()
    port = free_port()
    procs = []
    for rank in range(world):
        log = open(out_dir / f"rank{rank}.log", "w")
        cmd = [sys.executable, str(Path(__file__).resolve()),
               "--dp-rank", str(rank), "--dp-world", str(world),
               "--dp-port", str(port), "--dp-backend", backend,
               "--dp-out", str(out_dir)] + (["--dp-one-card"]
                                            if one_card else [])
        procs.append((subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    t0 = time.perf_counter()
    try:
        for proc, _ in procs:
            proc.wait(timeout=max(1.0, DP_TIMEOUT_S
                                  - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    ranks_s = time.perf_counter() - t0
    for rank, (proc, _) in enumerate(procs):
        tail = (out_dir / f"rank{rank}.log").read_text()[-3000:]
        require(proc.returncode == 0,
                f"{label}: rank {rank} exited {proc.returncode}:\n{tail}")
    outs = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]
    ref = dp_work(None, torch.device("cuda"))
    ctrl = dp_engine(None, torch.device("cuda"))
    ctrl_values, ctrl_grads = shard_steps(ctrl, dp_data(ctrl.full_config)[0],
                                          world)
    del ctrl
    n_steps = n_euler_steps(json.loads((ROOT / "configs" / "joint.json")
                                       .read_text()))
    expect_step = {"epdiff_step_fwd": n_steps * DP_STEPS,
                   "epdiff_step_bwd": n_steps * DP_STEPS,
                   "mc_warp_fwd": DP_STEPS, "mc_warp_disp_bwd": DP_STEPS}
    expect_test = {"epdiff_step_fwd": n_steps * 2, "mc_warp_fwd": 2}
    losses = ("registration_reconstruction", "registration_supervision",
              "TOS_regression", "total_loss")

    def rel(a, b):
        if isinstance(a, torch.Tensor):
            return float((a - b).norm()) / max(float(b.norm()), 1e-30)
        return abs(a - b) / abs(b)

    worst = dict.fromkeys(("shard values", "shard grads", "full values",
                           "full grads"), (0.0, ""))
    worst_tos = 0.0
    beyond = set()
    for rank, out in enumerate(outs):
        require(out["backend"] == backend,
                f"{label}: rank {rank} backend {out['backend']}")
        for name, want in (("step_launches", expect_step),
                           ("test_launches", expect_test)):
            got = {k: v for k, v in out[name].items() if v}
            require(got == want, f"{label}: rank {rank} {name} {got} != "
                                 f"{want}")
        # (what, rank's, full batch's, shards', full tol, shard tol)
        cases = [(f"step {i} {k}", a[k], b[k], c[k], 1e-3,
                  1e-5 if i == 0 else 1e-4)
                 for i, (a, b, c) in enumerate(zip(
                     out["values"], ref["values"], ctrl_values))
                 for k in losses + (("max_abs_displacement",)
                                    if i == 0 else ())]
        cases += [(k, out["grads"][k], g, ctrl_grads[k], 5e-2, 1e-5)
                  for k, g in ref["grads"].items()]
        failed = []
        for what, got, full, shard, tol, shard_tol in cases:
            kind = "values" if what.startswith("step ") else "grads"
            e_shard, e_full, e_ctrl = (rel(got, shard), rel(got, full),
                                       rel(shard, full))
            worst[f"shard {kind}"] = max(worst[f"shard {kind}"],
                                         (e_shard, what))
            worst[f"full {kind}"] = max(worst[f"full {kind}"], (e_full, what))
            if e_shard > shard_tol:
                failed.append(f"{what}: {e_shard:.3e} from one process "
                              f"summing the same shards (tol {shard_tol})")
            if e_full > tol:
                beyond.add(f"{what} {e_full:.3e} (shards summed in one "
                           f"process: {e_ctrl:.3e})")
                if e_full > e_ctrl + shard_tol:
                    failed.append(f"{what}: {e_full:.3e} from one rank on "
                                  f"the full batch (tol {tol}; one process "
                                  f"summing the shards: {e_ctrl:.3e})")
        require(not failed, f"{label}: rank {rank}: " + "; ".join(failed))
        span = float(np.ptp(ref["test_tos"])) or 1.0
        err = float(np.abs(out["test_tos"] - ref["test_tos"]).max()) / span
        worst_tos = max(worst_tos, err)
        require(out["test_tos"].shape == ref["test_tos"].shape
                and err <= 1.9e-2,
                f"{label}: rank {rank} test predictions {err} of the range")
        require(state_equal(out["params"], outs[0]["params"]),
                f"{label}: rank {rank}'s parameters differ from rank 0's")
        require(np.array_equal(out["test_tos"], outs[0]["test_tos"]),
                f"{label}: rank {rank}'s gathered predictions differ")
        if backend != "nccl":
            require(out["fuse_error"] is not None
                    and backend in out["fuse_error"],
                    f"{label}: epoch_fuse true on {backend}: "
                    f"{out['fuse_error']}")
    print(f"dp: {label}: {world} ranks ({backend}, "
          f"{'one card' if one_card else 'one card a rank'}; "
          f"{'step graph' if outs[0]['graph'] else 'step loop'}) of the "
          f"flagship at full width, batch 10 = {10 // world} slices x 19 "
          f"pairs a rank, {DP_STEPS} steps, in {ranks_s:.2f} s. Against "
          f"one process summing the same shards: values within "
          f"{worst['shard values'][0]:.3e} relative "
          f"({worst['shard values'][1]}; tol 1e-5 at step 0, 1e-4 after), "
          f"gradients within {worst['shard grads'][0]:.3e} relative L2 "
          f"({worst['shard grads'][1]}; tol 1e-5). Against one rank on the "
          f"full batch: values within {worst['full values'][0]:.3e} "
          f"relative ({worst['full values'][1]}; tol 1e-3), gradients "
          f"within {worst['full grads'][0]:.3e} relative L2 "
          f"({worst['full grads'][1]}; tol 5e-2)"
          + (f"; beyond the tolerance only where one process departs as "
             f"far (batch 5 against 10 on one card): {sorted(beyond)}"
             if beyond else "")
          + f"; ranks' parameters torch.equal; gathered test predictions "
          f"within {worst_tos:.3e} of the range (tol 1.9e-2); launches "
          f"a rank: steps {expect_step}, test {expect_test}"
          + (f"; epoch_fuse true raises: {outs[0]['fuse_error']}"
             if backend != "nccl" else ""))
    for rank, out in enumerate(outs):
        ar = out["all_reduce_ms"]
        print(f"dp: {label} rank {rank} ({card}): step host ms "
              f"{[round(x, 3) for x in out['host_ms']]}, device ms (CUDA "
              f"events) {[round(x, 3) for x in out['device_ms']]}; the "
              f"gradient all-reduce alone ({out['all_reduce_bytes']} bytes, "
              f"5 calls) host ms {[round(h, 3) for h, _ in ar]}, device ms "
              f"{[round(d, 3) for _, d in ar]}")
    print(f"dp: {label} one rank (reference, {card}): step host ms "
          f"{[round(x, 3) for x in ref['host_ms']]}, device ms "
          f"{[round(x, 3) for x in ref['device_ms']]}")
    return {k: outs[0]["step_launches"].get(k, 0)
            + outs[0]["test_launches"].get(k, 0)
            for k in outs[0]["step_launches"]}


def run_dp(tmp: Path, card: str):
    """dp2: two gloo ranks on this card; dp_cards: one NCCL rank a card on
    the graph path where two or more cards are visible."""
    paths = {"dp2": run_dp_ranks(tmp, card, "dp2", 2, "gloo", True)}
    n = torch.cuda.device_count()
    if n >= 2:
        paths["dp_cards"] = run_dp_ranks(tmp, card, "dp_cards", min(4, n),
                                         "nccl", False)
    else:
        print(f"dp_cards: skipped ({n} card visible)")
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None,
                    help="directory for profiler tables of the eval, train, "
                         "large train, fused-solve train, reg train, "
                         "regression train and analytic train steps, and of "
                         "the dispatch phase's loop and graph steps")
    ap.add_argument("--baseline", default=None,
                    help="a checkout of an earlier commit whose kernels "
                         "take the same C arguments: each kernel alone is "
                         "also timed from its sources, in turns with this "
                         "tree's, and compared with it bit for bit")
    # a rank of the dp2/dp_cards phases: this script started again
    for flag, kind in (("--dp-rank", int), ("--dp-world", int),
                       ("--dp-port", int), ("--dp-backend", str),
                       ("--dp-out", str)):
        ap.add_argument(flag, type=kind, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dp-one-card", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    if args.dp_rank is not None:
        return dp_rank_main(args)
    from cardiax_torch.device import deterministic, set_numerics
    set_numerics()
    dev = torch.device("cuda")
    card = phase_build()
    if args.baseline:
        build_baseline(Path(args.baseline).resolve())
    kernels = [check_k1(dev), check_k2(dev), check_k3_all(dev),
               check_k4(dev)]
    check_k2(dev, 14, 384, 256)       # the shooting grid of 768x512 frames
    for shape, row in (((14, 1, 768, 512), "B9"), ((14, 1, 384, 384), "B6")):
        check_k1(dev, *shape, rows=f"{row} value")
        check_k4(dev, *shape, rows=f"{row} ddy,ddx")
    check_k1_ragged(dev)
    check_k4_edges(dev)
    kernels.append(check_k5_all(dev))
    kernels += check_solve_all(dev)
    paths = {"eval": run_slice(args.profile)}
    with tempfile.TemporaryDirectory() as tmp:
        # the train, resume and dispatch phases compare runs bit for bit
        with deterministic():
            paths["train"], cfg_train, res_train = run_train(Path(tmp))
            res_resumed = run_resume(cfg_train)
            paths["dispatch"] = run_dispatch(
                Path(tmp), card, cfg_train, res_train, res_resumed,
                paths["train"])
            t_dp = time.perf_counter()
            paths["dp1"] = run_dp1(Path(tmp), cfg_train, res_train,
                                   paths["train"])
            dp_s = time.perf_counter() - t_dp
            del res_train, res_resumed
        dispatch_walls(Path(tmp), card, cfg_train, paths["train"])
        t_dp = time.perf_counter()
        paths.update(run_dp(Path(tmp), card))
        print(f"dp: phase (dp1, dp2, dp_cards) in "
              f"{dp_s + time.perf_counter() - t_dp:.2f} s")
    run_dispatch_times(card, args.profile)
    run_train_step(args.profile)
    paths["ops"] = run_ops()
    with tempfile.TemporaryDirectory() as tmp:
        paths["large"] = run_large(Path(tmp), args.profile)
    with tempfile.TemporaryDirectory() as tmp:
        paths["solve"] = run_solve(Path(tmp), args.profile)
    with tempfile.TemporaryDirectory() as tmp:
        paths["reg"] = run_reg(Path(tmp), card, args.profile)
    with tempfile.TemporaryDirectory() as tmp:
        paths["regression"] = run_schemes(Path(tmp), card, args.profile)
    with tempfile.TemporaryDirectory() as tmp:
        paths["analytic"] = run_analytic(Path(tmp), card, args.profile)
        paths["kfold"] = run_kfold_phase(Path(tmp), card)
    with tempfile.TemporaryDirectory() as tmp:
        paths["export"], paths["export_solve"] = run_export(Path(tmp), card)
    # launches: K1-K4 from the flagship's training run, K5 from the ops
    # path (the only one that needs a field gradient), K6/K7 from the
    # fused-solve run; every path's counts beside them (reg and
    # regression: K1-K4)
    main_path = {"mc_warp_fwd": "train", "epdiff_step_fwd": "train",
                 "epdiff_step_bwd": "train", "mc_warp_disp_bwd": "train",
                 "mc_warp_fused_bwd": "ops", "epdiff_step_solve_fwd": "solve",
                 "epdiff_step_solve_bwd": "solve"}
    rows = {"mc_warp_fwd": ["B3", "B6 value", "B9 value"],
            "epdiff_step_fwd": ["B1"], "epdiff_step_bwd": ["B2"],
            "mc_warp_disp_bwd": ["B4", "B6 ddy/ddx", "B9 ddy/ddx"],
            "mc_warp_fused_bwd": ["B5", "B7", "B8", "B10"],
            "epdiff_step_solve_fwd": ["B11"], "epdiff_step_solve_bwd": ["B12"]}
    for k in kernels:
        k["launches"] = paths[main_path[k["name"]]][k["name"]]
        k["launches_by_path"] = {p: c.get(k["name"], 0)
                                 for p, c in paths.items()}
        k["rows"] = rows[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_kernel_ms", "rows", "launches_by_path",
            "unfused_pair_ms", "unfused_pair_kernel_ms",
            "bound_cuda_core_ms", "baseline_kernel_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys if k in kern}
                                  for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
