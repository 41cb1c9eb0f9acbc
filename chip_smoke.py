#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``cardiax_torch``).

    python3 chip_smoke.py [--profile DIR]

Needs one CUDA device and ``nvcc``; exits non-zero on any failure and
prints no result without CUDA. Phases, one line each:

1. build: compile every kernel of the eval and train paths from
   ``cardiax_torch/csrc`` (one nvcc per source, in parallel) and print the
   card's name and power limit as ``nvidia-smi`` reports them;
2. kernels: each kernel (K1, K2 forward; K3, K4 backward) against its plain
   PyTorch version at the flagship shapes, with the displacement clamp and
   the border clip biting; its time (CUDA events), its byte/operation bound,
   the plain version's time and, where one exists, one PyTorch call
   computing the same function;
3. slice: ``TrainerEngine.test`` over 2 batches (the last one padded) at the
   full width of ``configs/joint.json`` (batch 10, 128^2, T=20, Ts=40, 126
   sectors, 5 Euler steps) with random weights from a seeded generator;
   finite losses, the kernels' launch counts, kernel vs plain on the same
   eval step, and the eval step's time;
4. train: ``cardiax_torch.main.run`` on ``configs/joint.json`` at full width
   for 2 epochs over a synthetic npy (train 25 slices in 3 batches, the last
   one padded; val 5; test 5): finite losses each epoch and the exact launch
   counts of the four kernels;
5. train step: kernel path vs plain path on one train step (loss and every
   parameter's gradient), a 10-step overfit of one batch, and the train
   step's time;
6. the kernel table as one JSON line, then the result line
   ``{"ok": true, "device": {...}}``.

``--profile DIR`` also writes ``torch.profiler`` tables of eval steps and
train steps to ``DIR/eval_profile.txt`` and ``DIR/train_profile.txt``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM data sheet, f32 outside tensor cores


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


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and f32
    operations over the f32 peak."""
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    o_ms = n_ops / F32_FLOPS_PER_S * 1e3
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
    print(f"build: mc_warp.cu (K1, K4) + epdiff_step.cu (K2, K3) with nvcc "
          f"for sm_90a in {secs:.2f} s")
    print(card)
    return card


def check_k1(dev):
    """K1 at the flagship's final warp: (190, 1, 128, 128), R=12."""
    from cardiax_torch.ops import warp_kernels as wk
    n, c, h, w, r = 190, 1, 128, 128, 12
    gen = torch.Generator().manual_seed(1)
    img = smooth(gen, (n, c, h, w), 1.0, dev)
    disp = smooth(gen, (n, 2, h, w), 24.0, dev)
    clamped = (disp.abs() > r - 1).any(dim=1).float().mean().item()
    ii = torch.arange(h, device=dev).view(1, h, 1).float()
    cy = ii + disp[:, 0].clamp(-(r - 1), r - 1)
    clipped = ((cy < 0) | (cy > h - 1)).float().mean().item()
    require(clamped > 0 and clipped > 0, "K1 check: clamp/clip do not bite")
    with torch.inference_mode():
        out = wk._mc_warp_cuda(img, disp, r)
        ref = wk._mc_warp_plain(img, disp, r)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = 1e-5 * max(1.0, ref.abs().max().item())
        require(err <= tol, f"K1 disagrees with its plain version: {err} > {tol}")
        # yardstick: grid_sample on the pre-clamped displacement (border
        # padding = the coordinate clip; align_corners=True = pixel centres)
        d = disp.clamp(-(r - 1), r - 1)
        jj = torch.arange(w, device=dev).view(1, 1, w).float()
        grid = torch.stack([(jj + d[:, 1]) * (2.0 / (w - 1)) - 1.0,
                            (ii + d[:, 0]) * (2.0 / (h - 1)) - 1.0], dim=-1)
        lib = lambda: torch.nn.functional.grid_sample(  # noqa: E731
            img, grid, mode="bilinear", padding_mode="border",
            align_corners=True)
        lib_err = (lib() - ref).abs().max().item()
        ms = time_ms(lambda: wk._mc_warp_cuda(img, disp, r))
        plain_ms = time_ms(lambda: wk._mc_warp_plain(img, disp, r))
        library_ms = time_ms(lib)
    pix = n * h * w
    bound_ms, bound_by = bound((2 * c + 2) * pix * 4, (18 + 9 * c) * pix)
    print(f"K1 mc_warp_fwd (190,1,128,128) R=12: max|kernel-plain| {err:.3e} "
          f"(tol {tol:.1e}), clamped {clamped:.3%}, clipped {clipped:.3%}, "
          f"{ms:.4f} ms vs bound {bound_ms:.4f} ms ({bound_by}), plain "
          f"{plain_ms:.4f} ms, grid_sample {library_ms:.4f} ms "
          f"(max|grid_sample-plain| {lib_err:.2e})")
    return {"name": "mc_warp_fwd", "route": "cuda",
            "source": "cardiax_torch/csrc/mc_warp.cu",
            "replaces": "cardiax/ops/warp_pallas.py:350",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def check_k2(dev):
    """K2 at the flagship's shooting grid: (190, 2, 64, 64), dt 0.2, R=2."""
    from cardiax_torch.ops import epdiff_kernels as ek
    n, h, w, dt, r = 190, 64, 64, 0.2, 2
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
        ms = time_ms(lambda: ek._epdiff_step_cuda(v, m, u, dt, r))
        plain_ms = time_ms(lambda: ek._epdiff_step_plain(v, m, u, dt, r))
    pix = n * h * w
    bound_ms, bound_by = bound(10 * pix * 4, 80 * pix)
    print(f"K2 epdiff_step_fwd (190,2,64,64) dt=0.2 R=2: max|kernel-plain| "
          f"{err:.3e} (tol {tol:.1e}), clamped {clamped:.3%}, {ms:.4f} ms vs "
          f"bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
          f"no single-call yardstick")
    return {"name": "epdiff_step_fwd", "route": "cuda",
            "source": "cardiax_torch/csrc/epdiff_step.cu",
            "replaces": "cardiax/ops/epdiff_pallas.py:157",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def check_k4(dev):
    """K4 at the flagship's final warp backward: (190, 1, 128, 128), R=12."""
    from cardiax_torch.ops import warp_kernels as wk
    n, c, h, w, r = 190, 1, 128, 128, 12
    gen = torch.Generator().manual_seed(4)
    img = smooth(gen, (n, c, h, w), 1.0, dev)
    disp = smooth(gen, (n, 2, h, w), 24.0, dev)
    g = torch.randn((n, c, h, w), generator=gen).to(dev)
    clamped = (disp.abs() > r - 1).any(dim=1).float().mean().item()
    ii = torch.arange(h, device=dev).view(1, h, 1).float()
    cy = ii + disp[:, 0]
    clipped = ((cy < 0) | (cy > h - 1)).float().mean().item()
    require(clamped > 0 and clipped > 0, "K4 check: clamp/clip do not bite")
    out = wk._mc_warp_disp_bwd_cuda(img, disp, g, r)
    ref = wk._mc_warp_disp_bwd_plain(img, disp, g, r)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    tol = 1e-5 * max(1.0, ref.abs().max().item())
    require(err <= tol, f"K4 disagrees with its plain version: {err} > {tol}")
    # yardstick: the grid gradient of grid_sample on the pre-clamped
    # displacement (border padding = the coordinate clip), image constant
    d = disp.clamp(-(r - 1), r - 1)
    jj = torch.arange(w, device=dev).view(1, 1, w).float()
    grid = torch.stack([(jj + d[:, 1]) * (2.0 / (w - 1)) - 1.0,
                        (ii + d[:, 0]) * (2.0 / (h - 1)) - 1.0],
                       dim=-1).requires_grad_()
    warped = torch.nn.functional.grid_sample(
        img, grid, mode="bilinear", padding_mode="border", align_corners=True)
    lib = lambda: torch.autograd.grad(warped, grid, g,  # noqa: E731
                                      retain_graph=True)
    ms = time_ms(lambda: wk._mc_warp_disp_bwd_cuda(img, disp, g, r))
    plain_ms = time_ms(lambda: wk._mc_warp_disp_bwd_plain(img, disp, g, r))
    library_ms = time_ms(lib)
    pix = n * h * w
    bound_ms, bound_by = bound((2 * c + 4) * pix * 4, (20 + 16 * c) * pix)
    print(f"K4 mc_warp_disp_bwd (190,1,128,128) R=12: max|kernel-plain| "
          f"{err:.3e} (tol {tol:.1e}), clamped {clamped:.3%}, clipped "
          f"{clipped:.3%}, {ms:.4f} ms vs bound {bound_ms:.4f} ms "
          f"({bound_by}), plain {plain_ms:.4f} ms, grid_sample grid-grad "
          f"{library_ms:.4f} ms")
    return {"name": "mc_warp_disp_bwd", "route": "cuda",
            "source": "cardiax_torch/csrc/mc_warp.cu",
            "replaces": "cardiax/ops/warp_pallas.py:441",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def check_k3(dev):
    """K3 at the flagship's shooting grid: (190, 2, 64, 64), dt 0.2, R=2."""
    from cardiax_torch.ops import epdiff_kernels as ek
    n, h, w, dt, r = 190, 64, 64, 0.2, 2
    gen = torch.Generator().manual_seed(3)
    v = smooth(gen, (n, 2, h, w), 12.0, dev)     # |dt v| up to 2.4 px
    m = smooth(gen, (n, 2, h, w), 3.0, dev)
    u = smooth(gen, (n, 2, h, w), 2.0, dev)
    gm = torch.randn((n, 2, h, w), generator=gen).to(dev)
    gu = torch.randn((n, 2, h, w), generator=gen).to(dev)
    clamped = ((dt * v).abs() > r - 1).any(dim=1).float().mean().item()
    ii = torch.arange(h, device=dev).view(1, h, 1).float()
    cy = ii + (-dt * v[:, 0]).clamp(-(r - 1), r - 1)
    clipped = ((cy < 0) | (cy > h - 1)).float().mean().item()
    require(clamped > 0 and clipped > 0, "K3 check: clamp/clip do not bite")
    outs = ek._epdiff_step_bwd_cuda(v, m, u, gm, gu, dt, r)
    refs = ek._epdiff_step_bwd_plain(v, m, u, gm, gu, dt, r)
    torch.cuda.synchronize()
    err = max((o - f).abs().max().item() for o, f in zip(outs, refs))
    tol = 1e-5 * max([1.0] + [f.abs().max().item() for f in refs])
    require(err <= tol, f"K3 disagrees with its plain version: {err} > {tol}")
    ms = time_ms(lambda: ek._epdiff_step_bwd_cuda(v, m, u, gm, gu, dt, r))
    plain_ms = time_ms(
        lambda: ek._epdiff_step_bwd_plain(v, m, u, gm, gu, dt, r))
    pix = n * h * w
    bound_ms, bound_by = bound(16 * pix * 4, 160 * pix)
    print(f"K3 epdiff_step_bwd (190,2,64,64) dt=0.2 R=2: max|kernel-plain| "
          f"{err:.3e} (tol {tol:.1e}), clamped {clamped:.3%}, clipped "
          f"{clipped:.3%}, {ms:.4f} ms vs bound {bound_ms:.4f} ms "
          f"({bound_by}), plain {plain_ms:.4f} ms, no single-call yardstick")
    return {"name": "epdiff_step_bwd", "route": "cuda",
            "source": "cardiax_torch/csrc/epdiff_step.cu",
            "replaces": "cardiax/ops/epdiff_pallas.py:192",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def random_nets(cfg, n_pairs: int, seed: int):
    """The flagship's networks with seeded random weights. JAX
    zero-initialises the momentum head (every warp would be the identity);
    small random weights there make the shooting and the warps real."""
    from cardiax_torch.models import build_model, init_weights
    gen = torch.Generator().manual_seed(seed)
    nets = {name: build_model(mc, n_pairs=n_pairs)
            for name, mc in cfg["networks"].items()}
    for b in nets.values():
        init_weights(b.module, gen)
        b.initialized = True
    head = nets["joint_register_strainmat"].module.momentum_unet.head
    with torch.no_grad():
        head.weight.copy_(torch.randn(head.weight.shape, generator=gen) * 0.05)
    return nets


@contextlib.contextmanager
def plain_path(sh, ek, wk):
    """The shooting and the final warp through the plain versions (autograd
    of the plain forwards), so no kernel launches."""
    saved = sh.epdiff_step, sh.bilinear_warp_banded_multi
    before = (ek.launches, ek.bwd_launches, wk.launches, wk.bwd_launches)
    try:
        sh.epdiff_step = ek._epdiff_step_plain
        sh.bilinear_warp_banded_multi = \
            lambda f, d, radius, img_const=False: wk._mc_warp_plain(f, d, radius)
        yield
    finally:
        sh.epdiff_step, sh.bilinear_warp_banded_multi = saved
    torch.cuda.synchronize()
    require((ek.launches, ek.bwd_launches, wk.launches, wk.bwd_launches)
            == before, "the plain run launched a kernel")


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
    dataset = JointDataset(data, ds_cfg)
    engine = build_trainer(cfg["training"], None, cfg)
    engine.setup(nets)
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
    ek.launches = 0
    wk.launches = 0
    preds, perf = engine.test({}, {"test": dataset})
    torch.cuda.synchronize()
    launches = {"epdiff_step_fwd": ek.launches, "mc_warp_fwd": wk.launches}
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
        write_profile(lambda: engine.eval_step(arrays), Path(profile_dir),
                      "eval")
    return launches


def write_profile(step, out_dir: Path, kind: str) -> None:
    """A profiler table of 3 calls of ``step`` (after one warm-up call)."""
    from torch.profiler import ProfilerActivity, profile
    out_dir.mkdir(parents=True, exist_ok=True)
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    path = out_dir / f"{kind}_profile.txt"
    path.write_text(f"{torch.cuda.get_device_name(0)}; 3 {kind} steps\n"
                    f"{table}\n")
    print(f"profile: {path}")


def run_train(tmp: Path):
    """``cardiax_torch.main.run`` on configs/joint.json at full width, with
    only the fields printed below changed; launch counts from 0 around it."""
    from cardiax_torch import main as port_main
    from cardiax_torch.data.synthetic import make_dataset, save_npy
    from cardiax_torch.ops import epdiff_kernels as ek
    from cardiax_torch.ops import warp_kernels as wk
    cfg = json.loads((ROOT / "configs" / "joint.json").read_text())
    t_myo = int(cfg["datasets"]["train"]["n_myo_frames_to_use_for_regression"])
    npy = tmp / "slices.npy"
    save_npy(str(npy), make_dataset(n_subjects=7, slices_per_subject=5,
                                    h=128, w=128, n_frames=t_myo, seed=5))
    changes = {
        "training.epochs": 2,
        "saving.saving_dir": str(tmp / "run"),
        "saving.save_checkpoint": False,
        "others.wandb_visualize_interval": 0,
        "data.npy_filename": str(npy),
        "data_split": {"method": "by_count", "splits": {
            "train": {"count": 25}, "val": {"count": 5},
            "test": {"count": 5}}},
    }
    for key, val in changes.items():
        node = cfg
        *path, leaf = key.split(".")
        for seg in path:
            node = node[seg]
        node[leaf] = val
    print(f"train: configs/joint.json with {json.dumps(changes)}")
    epochs = changes["training.epochs"]
    batch_size = int(cfg["training"]["batch_size"])
    n_steps = int(cfg["networks"]["joint_register_strainmat"]
                  ["n_integration_steps"])
    ek.launches = ek.bwd_launches = wk.launches = wk.bwd_launches = 0
    t0 = time.perf_counter()
    res = port_main.run(cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"mc_warp_fwd": wk.launches, "epdiff_step_fwd": ek.launches,
                "epdiff_step_bwd": ek.bwd_launches,
                "mc_warp_disp_bwd": wk.bwd_launches}
    train_steps = epochs * math.ceil(25 / batch_size)
    # validation every epoch, then the final val and test evaluations
    eval_batches = epochs + 2
    expect = {"mc_warp_fwd": train_steps + eval_batches,
              "epdiff_step_fwd": n_steps * (train_steps + eval_batches),
              "epdiff_step_bwd": n_steps * train_steps,
              "mc_warp_disp_bwd": train_steps}
    require(launches == expect, f"train launches {launches} != {expect}")
    hist = res["train_loss_dict"]
    for key in ("train/total_loss", "val/total_loss"):
        require(len(hist[key]) == epochs
                and all(math.isfinite(v) for v in hist[key]),
                f"{key} per epoch: {hist[key]}")
    perf = {k: v for t in ("val", "test")
            for k, v in res[f"{t}_performance"].items()}
    require(all(math.isfinite(v) for v in perf.values()),
            f"non-finite metric: {perf}")
    require((tmp / "run" / "model-joint_register_strainmat.pt").is_file(),
            "the trained model was not saved")
    print(f"train: main.run {epochs} epochs x {train_steps // epochs} train "
          f"steps (last batch padded) + {eval_batches} eval batches in "
          f"{secs:.2f} s; total_loss per epoch train "
          f"{[round(v, 6) for v in hist['train/total_loss']]}, val "
          f"{[round(v, 6) for v in hist['val/total_loss']]}; launches "
          f"{launches}")
    return launches


def run_train_step(profile_dir):
    """Kernel path vs plain path on one train step, a 10-step overfit of
    one batch, and the train step's time, at full width."""
    from cardiax_torch.data.datasets import JointDataset
    from cardiax_torch.data.loader import Batcher
    from cardiax_torch.data.synthetic import make_dataset
    from cardiax_torch.ops import epdiff_kernels as ek
    from cardiax_torch.ops import shooting as sh
    from cardiax_torch.ops import warp_kernels as wk
    from cardiax_torch.train import build_trainer
    cfg = json.loads((ROOT / "configs" / "joint.json").read_text())
    ds_cfg = cfg["datasets"]["train"]
    t_myo = int(ds_cfg["n_myo_frames_to_use_for_regression"])
    batch_size = int(cfg["training"]["batch_size"])
    data = make_dataset(n_subjects=5, slices_per_subject=2, h=128, w=128,
                        n_frames=t_myo, seed=6)
    dataset = JointDataset(data, ds_cfg)
    batch = next(iter(Batcher(dataset, batch_size)))

    def fresh_engine():
        engine = build_trainer(cfg["training"], None, cfg)
        engine.setup(random_nets(cfg, t_myo - 1, seed=1), steps_per_epoch=3)
        return engine

    engine = fresh_engine()
    arrays = engine.to_device(batch)
    before = (ek.bwd_launches, wk.bwd_launches)
    values_k = engine.backward(arrays)
    grads_k = {f"{n}.{k}": p.grad.detach().clone()
               for n, mod in engine.modules.items()
               for k, p in mod.named_parameters()}
    torch.cuda.synchronize()
    n_steps = int(cfg["networks"]["joint_register_strainmat"]
                  ["n_integration_steps"])
    require((ek.bwd_launches - before[0], wk.bwd_launches - before[1])
            == (n_steps, 1), "the kernel train step missed K3/K4")
    with plain_path(sh, ek, wk):
        values_p = engine.backward(arrays)
    grads_p = {f"{n}.{k}": p.grad.detach().clone()
               for n, mod in engine.modules.items()
               for k, p in mod.named_parameters()}
    tl_k, tl_p = values_k["total_loss"].item(), values_p["total_loss"].item()
    require(abs(tl_k - tl_p) <= 1e-3 * max(1.0, abs(tl_p)),
            f"train step total_loss: kernel path {tl_k} vs plain {tl_p}")
    rel = {}
    for k, gp in grads_p.items():
        norm = gp.norm().item()
        rel[k] = (grads_k[k] - gp).norm().item() / norm if norm > 0 else \
            grads_k[k].norm().item()
    worst = max(rel, key=rel.get)
    require(rel[worst] <= 5e-2,
            f"gradient of {worst}: kernel vs plain relative L2 {rel[worst]}")
    print(f"train step kernel vs plain: total_loss {tl_k:.6g} vs {tl_p:.6g} "
          f"(tol 1e-3 rel), gradients of {len(rel)} tensors within relative "
          f"L2 {rel[worst]:.3e} (worst {worst}; tol 5e-2), median "
          f"{sorted(rel.values())[len(rel) // 2]:.3e}")

    # overfit one batch: 10 optimiser steps, the loss must fall
    losses = [engine.train_step(arrays)["total_loss"].item()
              for _ in range(10)]
    require(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
            f"overfit: total_loss did not fall: {losses}")
    print(f"overfit: 10 train steps on one batch, total_loss "
          f"{losses[0]:.6g} -> {losses[-1]:.6g}")

    # train step time: host clock around synchronised steps
    engine = fresh_engine()
    for _ in range(2):
        engine.train_step(arrays)
    torch.cuda.synchronize()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.train_step(arrays)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for mod in engine.modules.values()
                   for p in mod.parameters())
    print(f"train step: {step_ms:.3f} ms/batch of {batch_size} slices = "
          f"{batch_size / step_ms * 1e3:.1f} slices/s ({reps} steps after 2 "
          f"warm-up steps; {n_params} parameters; peak device memory "
          f"{peak_gb:.2f} GB)")
    if profile_dir:
        write_profile(lambda: engine.train_step(arrays), Path(profile_dir),
                      "train")



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None,
                    help="directory for profiler tables of eval and train "
                         "steps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    from cardiax_torch.device import set_numerics
    set_numerics()
    dev = torch.device("cuda")
    phase_build()
    kernels = [check_k1(dev), check_k2(dev), check_k3(dev), check_k4(dev)]
    run_slice(args.profile)
    with tempfile.TemporaryDirectory() as tmp:
        launches = run_train(Path(tmp))
    run_train_step(args.profile)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
