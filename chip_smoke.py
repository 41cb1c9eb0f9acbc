#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``cardiax_torch``).

    python3 chip_smoke.py [--profile DIR]

Needs one CUDA device and ``nvcc``; exits non-zero on any failure and
prints no result without CUDA. Phases, one line each:

1. build: compile every kernel of the eval path from ``cardiax_torch/csrc``
   (one nvcc per source, in parallel) and print the card's name and power
   limit as ``nvidia-smi`` reports them;
2. kernels: each kernel against its plain PyTorch version at the flagship
   shapes, with the displacement clamp and the border clip biting; its time
   (CUDA events), its byte/operation bound, the plain version's time and,
   where one exists, one PyTorch call computing the same function;
3. slice: ``TrainerEngine.test`` over 2 batches (the last one padded) at the
   full width of ``configs/joint.json`` (batch 10, 128^2, T=20, Ts=40, 126
   sectors, 5 Euler steps) with random weights from a seeded generator;
   finite losses, the kernels' launch counts, kernel vs plain on the same
   eval step, and the eval step's time;
4. the kernel table as one JSON line, then the result line
   ``{"ok": true, "device": {...}}``.

``--profile DIR`` also writes a ``torch.profiler`` table of one eval step
to ``DIR/eval_profile.txt``.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
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
    print(f"build: mc_warp.cu + epdiff_step.cu with nvcc for sm_90a in "
          f"{secs:.2f} s")
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


def build_slice(seed: int = 0):
    """The flagship at full width with seeded random weights, the engine on
    the card, and a 15-slice synthetic test set (batches of 10 and 5+5)."""
    from cardiax_torch.data.datasets import JointDataset
    from cardiax_torch.data.synthetic import make_dataset
    from cardiax_torch.models import build_model
    from cardiax_torch.models.layers import init_weights
    from cardiax_torch.train import build_trainer
    cfg = json.loads((ROOT / "configs" / "joint.json").read_text())
    ds_cfg = cfg["datasets"]["test"]
    t_myo = int(ds_cfg["n_myo_frames_to_use_for_regression"])
    gen = torch.Generator().manual_seed(seed)
    nets = {name: build_model(mc, n_pairs=t_myo - 1)
            for name, mc in cfg["networks"].items()}
    for b in nets.values():
        init_weights(b.module, gen)
    # JAX zero-initialises the momentum head (every warp would be the
    # identity); small random weights make the shooting and warps real
    head = nets["joint_register_strainmat"].module.momentum_unet.head
    with torch.no_grad():
        head.weight.copy_(torch.randn(head.weight.shape, generator=gen) * 0.05)
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
    saved = sh.epdiff_step, sh.bilinear_warp_banded_multi
    before = (ek.launches, wk.launches)
    try:
        sh.epdiff_step = ek._epdiff_step_plain
        sh.bilinear_warp_banded_multi = wk._mc_warp_plain
        values_p, preds_p = engine.eval_step(arrays)
    finally:
        sh.epdiff_step, sh.bilinear_warp_banded_multi = saved
    torch.cuda.synchronize()
    require((ek.launches, wk.launches) == before,
            "the plain run launched a kernel")
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
        write_profile(engine, arrays, Path(profile_dir))
    return launches


def write_profile(engine, arrays, out_dir: Path) -> None:
    from torch.profiler import ProfilerActivity, profile
    out_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            engine.eval_step(arrays)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    (out_dir / "eval_profile.txt").write_text(
        f"{torch.cuda.get_device_name(0)}; 3 eval steps\n{table}\n")
    print(f"profile: {out_dir / 'eval_profile.txt'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None,
                    help="directory for a profiler table of one eval step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    from cardiax_torch.device import set_numerics
    set_numerics()
    dev = torch.device("cuda")
    phase_build()
    kernels = [check_k1(dev), check_k2(dev)]
    launches = run_slice(args.profile)
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
