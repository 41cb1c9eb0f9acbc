#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``cardiax_torch``).

    python3 chip_smoke.py [--profile DIR]

Needs one CUDA device and ``nvcc``; exits non-zero on any failure and
prints no result without CUDA. Phases, one line each:

1. build: compile every kernel of the paths below from
   ``cardiax_torch/csrc`` (one nvcc per source, in parallel) and print the
   card's name and power limit as ``nvidia-smi`` reports them;
2. kernels: each kernel (K1, K2 forward; K3, K4, K5 backward) against its
   plain PyTorch version, with the displacement clamp and the border clip
   biting, at the flagship shapes and at those of the TPU kernels it stands
   for (K1/K4 at C = 1 at 384x384 and 768x512 frames; K5 at the in-scan
   grid of 768x512 frames, the flagship's final warp and 768x512 frames);
   its time (CUDA events), its byte/operation bound, the plain version's
   time and, where one exists, one PyTorch call computing the same function;
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
8. the kernel table as one JSON line, then the result line
   ``{"ok": true, "device": {...}}``.

``--profile DIR`` also writes ``torch.profiler`` tables of eval steps and
train steps to ``DIR/eval_profile.txt``, ``DIR/train_profile.txt`` and
``DIR/large_train_profile.txt``.
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
import types
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
    print(f"build: mc_warp.cu (K1, K4, K5) + epdiff_step.cu (K2, K3) with "
          f"nvcc for sm_90a in {secs:.2f} s")
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
    default."""
    from cardiax_torch.ops import warp_kernels as wk
    gen = torch.Generator().manual_seed(1)
    img = smooth(gen, (n, c, h, w), 1.0, dev)
    disp = smooth(gen, (n, 2, h, w), 24.0, dev)
    clamped, clipped = clip_shares(disp, r)
    with torch.inference_mode():
        out = wk._mc_warp_cuda(img, disp, r)
        ref = wk._mc_warp_plain(img, disp, r)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = 1e-5 * max(1.0, ref.abs().max().item())
        require(err <= tol, f"K1 disagrees with its plain version: {err} > {tol}")
        grid = sample_grid(disp, r)
        lib = lambda: grid_sample(img, grid)  # noqa: E731
        lib_err = (lib() - ref).abs().max().item()
        ms = time_ms(lambda: wk._mc_warp_cuda(img, disp, r))
        plain_ms = time_ms(lambda: wk._mc_warp_plain(img, disp, r))
        library_ms = time_ms(lib)
    pix = n * h * w
    bound_ms, bound_by = bound((2 * c + 2) * pix * 4, (18 + 9 * c) * pix)
    print(f"K1 mc_warp_fwd ({n},{c},{h},{w}) R={r} [{rows}]: max|kernel-"
          f"plain| {err:.3e} (tol {tol:.1e}), clamped {clamped:.3%}, clipped "
          f"{clipped:.3%}, {ms:.4f} ms vs bound {bound_ms:.4f} ms "
          f"({bound_by}), plain {plain_ms:.4f} ms, grid_sample "
          f"{library_ms:.4f} ms (max|grid_sample-plain| {lib_err:.2e})")
    return {"name": "mc_warp_fwd", "route": "cuda",
            "source": "cardiax_torch/csrc/mc_warp.cu",
            "replaces": "cardiax/ops/warp_pallas.py:350",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


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
        ms = time_ms(lambda: ek._epdiff_step_cuda(v, m, u, dt, r))
        plain_ms = time_ms(lambda: ek._epdiff_step_plain(v, m, u, dt, r))
    pix = n * h * w
    bound_ms, bound_by = bound(10 * pix * 4, 80 * pix)
    print(f"K2 epdiff_step_fwd ({n},2,{h},{w}) dt=0.2 R=2: max|kernel-plain| "
          f"{err:.3e} (tol {tol:.1e}), clamped {clamped:.3%}, {ms:.4f} ms vs "
          f"bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
          f"no single-call yardstick")
    return {"name": "epdiff_step_fwd", "route": "cuda",
            "source": "cardiax_torch/csrc/epdiff_step.cu",
            "replaces": "cardiax/ops/epdiff_pallas.py:157",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def check_k4(dev, n=190, c=1, h=128, w=128, r=12, rows="B4"):
    """K4 at the flagship's final warp backward, (190, 1, 128, 128), R=12,
    by default."""
    from cardiax_torch.ops import warp_kernels as wk
    gen = torch.Generator().manual_seed(4)
    img = smooth(gen, (n, c, h, w), 1.0, dev)
    disp = smooth(gen, (n, 2, h, w), 24.0, dev)
    g = torch.randn((n, c, h, w), generator=gen).to(dev)
    clamped, clipped = clip_shares(disp, r)
    out = wk._mc_warp_disp_bwd_cuda(img, disp, g, r)
    ref = wk._mc_warp_disp_bwd_plain(img, disp, g, r)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    tol = 1e-5 * max(1.0, ref.abs().max().item())
    require(err <= tol, f"K4 disagrees with its plain version: {err} > {tol}")
    # yardstick: the grid gradient of grid_sample on the pre-clamped
    # displacement, image constant
    grid = sample_grid(disp, r).requires_grad_()
    warped = grid_sample(img, grid)
    lib = lambda: torch.autograd.grad(warped, grid, g,  # noqa: E731
                                      retain_graph=True)
    ms = time_ms(lambda: wk._mc_warp_disp_bwd_cuda(img, disp, g, r))
    plain_ms = time_ms(lambda: wk._mc_warp_disp_bwd_plain(img, disp, g, r))
    library_ms = time_ms(lib)
    pix = n * h * w
    bound_ms, bound_by = bound((2 * c + 4) * pix * 4, (20 + 16 * c) * pix)
    print(f"K4 mc_warp_disp_bwd ({n},{c},{h},{w}) R={r} [{rows}]: max|kernel-"
          f"plain| {err:.3e} (tol {tol:.1e}), clamped {clamped:.3%}, clipped "
          f"{clipped:.3%}, {ms:.4f} ms vs bound {bound_ms:.4f} ms "
          f"({bound_by}), plain {plain_ms:.4f} ms, grid_sample grid-grad "
          f"{library_ms:.4f} ms")
    return {"name": "mc_warp_disp_bwd", "route": "cuda",
            "source": "cardiax_torch/csrc/mc_warp.cu",
            "replaces": "cardiax/ops/warp_pallas.py:441",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def check_k5(dev, n, c, h, w, r, scale, rows):
    """K5 (both outputs) against its plain version at (n, c, h, w) with a
    displacement of max |value| ``scale`` px."""
    from cardiax_torch.ops import warp_kernels as wk
    gen = torch.Generator().manual_seed(5)
    img = smooth(gen, (n, c, h, w), 1.0, dev)
    disp = smooth(gen, (n, 2, h, w), scale, dev)
    g = torch.randn((n, c, h, w), generator=gen).to(dev)
    shares = clip_shares(disp, r) if scale > r - 1 else None
    outs = wk._mc_warp_fused_bwd_cuda(img, disp, g, r)
    refs = wk._mc_warp_fused_bwd_plain(img, disp, g, r)
    torch.cuda.synchronize()
    err = max((o - f).abs().max().item() for o, f in zip(outs, refs))
    tol = 1e-5 * max([1.0] + [f.abs().max().item() for f in refs])
    require(err <= tol, f"K5 disagrees with its plain version at "
            f"{(n, c, h, w)} R={r}: {err} > {tol}")
    # yardstick: grid_sample's gradients w.r.t. the input and the grid
    f = img.clone().requires_grad_()
    grid = sample_grid(disp, r).requires_grad_()
    warped = grid_sample(f, grid)
    lib = lambda: torch.autograd.grad(warped, (f, grid), g,  # noqa: E731
                                      retain_graph=True)
    ms = time_ms(lambda: wk._mc_warp_fused_bwd_cuda(img, disp, g, r))
    plain_ms = time_ms(lambda: wk._mc_warp_fused_bwd_plain(img, disp, g, r),
                       iters=5, warmup=1)
    library_ms = time_ms(lib)
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
    print(f"K5 mc_warp_fused_bwd ({n},{c},{h},{w}) R={r} max|disp| {scale} "
          f"[{rows}]: max|kernel-plain| {err:.3e} (tol {tol:.1e}), {bite}"
          f"gather band {band[0]}x{band[1]} (of {r}), {ms:.4f} ms vs bound "
          f"{bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
          f"grid_sample input+grid grad {library_ms:.4f} ms")
    return {"name": "mc_warp_fused_bwd", "route": "cuda",
            "source": "cardiax_torch/csrc/mc_warp.cu",
            "replaces": "cardiax/ops/warp_pallas.py:402",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def check_k5_all(dev):
    """K5 at the in-scan grid of 768x512 frames (B5's shape on the TPU),
    the ops path's ``expmap_svf`` (C=2, R=8), the flagship's final warp and
    768x512 frames (B10's), the clamp and clip biting; and at the flagship's
    final warp with a trained model's displacement (max 1.9 px). Returns
    the entry at the flagship's warp."""
    check_k5(dev, 14, 2, 384, 256, 2, 3.0, "B5")
    check_k5(dev, 190, 2, 128, 128, 8, 18.0, "B5, expmap_svf")
    entry = check_k5(dev, 190, 1, 128, 128, 12, 24.0, "B7/B8")
    check_k5(dev, 14, 1, 768, 512, 12, 24.0, "B10")
    check_k5(dev, 190, 1, 128, 128, 12, 1.9, "B7/B8, trained-model band")
    return entry


def check_k3(dev, n=190, h=64, w=64):
    """K3 at the flagship's shooting grid, (190, 2, 64, 64), by default;
    dt 0.2, R=2."""
    from cardiax_torch.ops import epdiff_kernels as ek
    dt, r = 0.2, 2
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
    print(f"K3 epdiff_step_bwd ({n},2,{h},{w}) dt=0.2 R=2: max|kernel-plain| "
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


def counts(ek, wk):
    return (ek.launches, ek.bwd_launches, wk.launches, wk.bwd_launches,
            wk.fused_bwd_launches)


@contextlib.contextmanager
def plain_path(sh, ek, wk):
    """The shooting and every banded warp through the plain versions
    (autograd of the plain forwards), so no kernel launches."""
    saved = sh.epdiff_step, wk.MCWarp
    before = counts(ek, wk)
    try:
        sh.epdiff_step = ek._epdiff_step_plain
        wk.MCWarp = types.SimpleNamespace(
            apply=lambda f, d, radius: wk._mc_warp_plain(f, d, radius))
        yield
    finally:
        sh.epdiff_step, wk.MCWarp = saved
    torch.cuda.synchronize()
    require(counts(ek, wk) == before, "the plain run launched a kernel")


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
        busy_ms, prof = profile_steps(lambda: engine.eval_step(arrays))
        print(f"eval step: {busy_line(busy_ms, step_ms)}")
        write_profile(prof, Path(profile_dir), "eval")
    return launches


def profile_steps(step, reps: int = 3):
    """Profile ``reps`` calls of ``step`` after one warm-up call. Returns
    the device time per call, the union of the CUDA kernels' intervals (or
    None if the trace holds no device events), and the profile."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None, prof
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    busy += hi - lo
    return busy / reps / 1e3, prof


def busy_line(busy_ms, step_ms: float) -> str:
    """The device-busy line of a profiled step against its host time."""
    if busy_ms is None:
        return "device busy not measured (no device events in the trace)"
    return (f"device busy {busy_ms:.3f} ms a step from the profiler over 3 "
            f"steps ({1 - busy_ms / step_ms:.1%} idle)")


def write_profile(prof, out_dir: Path, kind: str) -> None:
    """The profiler table of 3 ``kind`` steps, to ``out_dir``."""
    out_dir.mkdir(parents=True, exist_ok=True)
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
    ek.launches = ek.bwd_launches = 0
    wk.launches = wk.bwd_launches = wk.fused_bwd_launches = 0
    t0 = time.perf_counter()
    res = port_main.run(cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"mc_warp_fwd": wk.launches, "epdiff_step_fwd": ek.launches,
                "epdiff_step_bwd": ek.bwd_launches,
                "mc_warp_disp_bwd": wk.bwd_launches,
                "mc_warp_fused_bwd": wk.fused_bwd_launches}
    train_steps = epochs * math.ceil(25 / batch_size)
    # validation every epoch, then the final val and test evaluations
    eval_batches = epochs + 2
    expect = {"mc_warp_fwd": train_steps + eval_batches,
              "epdiff_step_fwd": n_steps * (train_steps + eval_batches),
              "epdiff_step_bwd": n_steps * train_steps,
              "mc_warp_disp_bwd": train_steps, "mc_warp_fused_bwd": 0}
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


def grads_of(engine):
    return {f"{n}.{k}": p.grad.detach().clone()
            for n, mod in engine.modules.items()
            for k, p in mod.named_parameters()}


def kernel_vs_plain_step(cfg, batch, label):
    """One train step (loss and every parameter's gradient) through the
    kernels and through the plain versions, on the same random weights.
    Returns a factory of fresh engines and the batch on the card."""
    from cardiax_torch.ops import epdiff_kernels as ek
    from cardiax_torch.ops import shooting as sh
    from cardiax_torch.ops import warp_kernels as wk
    from cardiax_torch.train import build_trainer
    t_myo = int(cfg["datasets"]["train"]["n_myo_frames_to_use_for_regression"])

    def fresh_engine():
        engine = build_trainer(cfg["training"], None, cfg)
        engine.setup(random_nets(cfg, t_myo - 1, seed=1), steps_per_epoch=3)
        return engine

    engine = fresh_engine()
    arrays = engine.to_device(batch)
    before = counts(ek, wk)
    values_k = engine.backward(arrays)
    grads_k = grads_of(engine)
    torch.cuda.synchronize()
    n_steps = int(cfg["networks"]["joint_register_strainmat"]
                  ["n_integration_steps"])
    step_counts = tuple(a - b for a, b in zip(counts(ek, wk), before))
    require(step_counts == (n_steps, n_steps, 1, 1, 0),
            f"{label}: the kernel train step launched (K2, K3, K1, K4, K5) = "
            f"{step_counts}, not ({n_steps}, {n_steps}, 1, 1, 0)")
    with plain_path(sh, ek, wk):
        values_p = engine.backward(arrays)
    grads_p = grads_of(engine)
    tl_k, tl_p = values_k["total_loss"].item(), values_p["total_loss"].item()
    require(abs(tl_k - tl_p) <= 1e-3 * max(1.0, abs(tl_p)),
            f"{label} total_loss: kernel path {tl_k} vs plain {tl_p}")
    rel = {}
    for k, gp in grads_p.items():
        norm = gp.norm().item()
        rel[k] = (grads_k[k] - gp).norm().item() / norm if norm > 0 else \
            grads_k[k].norm().item()
    worst = max(rel, key=rel.get)
    require(rel[worst] <= 5e-2,
            f"{label}: gradient of {worst}: kernel vs plain relative L2 "
            f"{rel[worst]}")
    print(f"{label} kernel vs plain: total_loss {tl_k:.6g} vs {tl_p:.6g} "
          f"(tol 1e-3 rel), gradients of {len(rel)} tensors within relative "
          f"L2 {rel[worst]:.3e} (worst {worst}; tol 5e-2), median "
          f"{sorted(rel.values())[len(rel) // 2]:.3e}; max|u_inv| "
          f"{values_k['max_abs_displacement'].item():.3f} px; launches "
          f"(K2, K3, K1, K4, K5) {step_counts}")
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
    batch = next(iter(Batcher(JointDataset(data, ds_cfg), batch_size)))
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
        print(f"train step: {busy_line(busy_ms, step_ms)}")
        write_profile(prof, Path(profile_dir), "train")


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

    ek.launches = ek.bwd_launches = 0
    wk.launches = wk.bwd_launches = wk.fused_bwd_launches = 0
    outs_k, grads_k = run()
    torch.cuda.synchronize()
    launches = {"mc_warp_fwd": wk.launches, "mc_warp_disp_bwd": wk.bwd_launches,
                "mc_warp_fused_bwd": wk.fused_bwd_launches,
                "epdiff_step_fwd": ek.launches,
                "epdiff_step_bwd": ek.bwd_launches}
    # expmap_svf: one K1 and one K5 per squaring; compose: one each per
    # channel; deform_image: one each
    expect = {"mc_warp_fwd": 7, "mc_warp_disp_bwd": 0, "mc_warp_fused_bwd": 7,
              "epdiff_step_fwd": 0, "epdiff_step_bwd": 0}
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
    from cardiax_torch.ops import epdiff_kernels as ek
    from cardiax_torch.ops import warp_kernels as wk
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
    ek.launches = ek.bwd_launches = 0
    wk.launches = wk.bwd_launches = wk.fused_bwd_launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = port_main.run(cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    run_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {"mc_warp_fwd": wk.launches, "epdiff_step_fwd": ek.launches,
                "epdiff_step_bwd": ek.bwd_launches,
                "mc_warp_disp_bwd": wk.bwd_launches,
                "mc_warp_fused_bwd": wk.fused_bwd_launches}
    train_steps = epochs * 2
    eval_batches = epochs + 2      # val each epoch, final val and test
    expect = {"mc_warp_fwd": train_steps + eval_batches,
              "epdiff_step_fwd": n_steps * (train_steps + eval_batches),
              "epdiff_step_bwd": n_steps * train_steps,
              "mc_warp_disp_bwd": train_steps, "mc_warp_fused_bwd": 0}
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

    ds = JointDataset(data, cfg["datasets"]["train"])
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
          f"memory {peak_gb:.2f} GB")
    if profile_dir:
        write_profile(prof, Path(profile_dir), "large_train")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None,
                    help="directory for profiler tables of the eval, train "
                         "and large train steps")
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
    check_k2(dev, 14, 384, 256)       # the shooting grid of 768x512 frames
    check_k3(dev, 14, 384, 256)
    for shape, row in (((14, 1, 768, 512), "B9"), ((14, 1, 384, 384), "B6")):
        check_k1(dev, *shape, rows=f"{row} value")
        check_k4(dev, *shape, rows=f"{row} ddy,ddx")
    kernels.append(check_k5_all(dev))
    paths = {"eval": run_slice(args.profile)}
    with tempfile.TemporaryDirectory() as tmp:
        paths["train"] = run_train(Path(tmp))
    run_train_step(args.profile)
    paths["ops"] = run_ops()
    with tempfile.TemporaryDirectory() as tmp:
        paths["large"] = run_large(Path(tmp), args.profile)
    # launches: K1-K4 from the flagship's training run, K5 from the ops
    # path (the only one that needs a field gradient); every path's counts
    # beside them
    main_path = {"mc_warp_fwd": "train", "epdiff_step_fwd": "train",
                 "epdiff_step_bwd": "train", "mc_warp_disp_bwd": "train",
                 "mc_warp_fused_bwd": "ops"}
    rows = {"mc_warp_fwd": ["B3", "B6 value", "B9 value"],
            "epdiff_step_fwd": ["B1"], "epdiff_step_bwd": ["B2"],
            "mc_warp_disp_bwd": ["B4", "B6 ddy/ddx", "B9 ddy/ddx"],
            "mc_warp_fused_bwd": ["B5", "B7", "B8", "B10"]}
    for k in kernels:
        k["launches"] = paths[main_path[k["name"]]][k["name"]]
        k["launches_by_path"] = {p: c.get(k["name"], 0)
                                 for p, c in paths.items()}
        k["rows"] = rows[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "rows",
            "launches_by_path")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
