"""The port's CUDA kernels against their plain PyTorch versions, on the card.

K1/K2 are the forward warp and EPDiff step, K4/K3 their backward kernels,
K5 the warp's full backward (d/d field and d/d disp; also at its hard cases,
``k5_case``, with two launches bit-identical), K6/K7 the EPDiff step
with the fluid-metric solve inside the kernel and its backward; one test
per autograd Function checks that a backward through autograd on the card
launches its kernel.

Marked ``gpu``: without a CUDA device each test skips (decided inside the
fixture, not at import). On a machine with an H100 run
``python -m pytest tests/test_torch_kernels.py``; the kernels build from
``cardiax_torch/csrc`` on first use. Tolerance: f32, 1e-5 relative to the
output's largest magnitude (the kernel may contract a*b+c into one fma
where the plain version rounds twice).
"""

import gc

import numpy as np
import pytest
import torch

from cardiax_torch.device import deterministic
from cardiax_torch.ops import (counters, epdiff_kernels, shooting,
                               warp_kernels)
from cardiax_torch.ops.fluid_metric import _helmholtz_mm_weights
from torch_budget import time_limit  # noqa: F401

LAUNCHES = counters.launches     # by kernel name

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _smooth(gen, shape, scale, device):
    x = torch.randn(shape, generator=gen)
    x = torch.nn.functional.avg_pool2d(x.reshape(-1, 1, *shape[-2:]), 5, 1, 2)
    x = x.reshape(shape)
    return (x / x.abs().max() * scale).to(device)


def _close(out, ref):
    err = (out - ref).abs().max().item()
    assert err <= 1e-5 * max(1.0, ref.abs().max().item()), err


@pytest.mark.parametrize("channels", [1, 2])
def test_mc_warp_kernel_matches_plain(cuda, channels):
    gen = torch.Generator().manual_seed(channels)
    img = _smooth(gen, (6, channels, 40, 36), 3.0, cuda)
    disp = _smooth(gen, (6, 2, 40, 36), 15.0, cuda)
    assert (disp.abs() > 11).any()
    before = LAUNCHES["mc_warp_fwd"]
    with torch.inference_mode():
        out = warp_kernels.bilinear_warp_banded_multi(img, disp, radius=12)
        ref = warp_kernels._mc_warp_plain(img, disp, 12)
    torch.cuda.synchronize()
    assert LAUNCHES["mc_warp_fwd"] == before + 1
    _close(out, ref)


def test_epdiff_step_kernel_matches_plain(cuda):
    gen = torch.Generator().manual_seed(0)
    v = _smooth(gen, (5, 2, 24, 20), 9.0, cuda)
    m = _smooth(gen, (5, 2, 24, 20), 3.0, cuda)
    u = _smooth(gen, (5, 2, 24, 20), 2.0, cuda)
    assert (0.2 * v.abs() > 1).any()
    before = LAUNCHES["epdiff_step_fwd"]
    with torch.inference_mode():
        mk, uk = epdiff_kernels.epdiff_step(v, m, u, 0.2, 2)
        mr, ur = epdiff_kernels._epdiff_step_plain(v, m, u, 0.2, 2)
    torch.cuda.synchronize()
    assert LAUNCHES["epdiff_step_fwd"] == before + 1
    _close(mk, mr)
    _close(uk, ur)
    assert np.isfinite(uk.cpu().numpy()).all()


# the CPU cases' shapes (tests/test_torch_ops.py): C = 3 takes the kernel's
# two passes over the channels, a width of 37 its scalar loads and stores
@pytest.mark.parametrize("shape, seed", [
    pytest.param((6, 2, 40, 36), 7, id="2"),
    pytest.param((2, 1, 32, 32), 31, id="1"),
    pytest.param((2, 3, 30, 37), 33, id="3-30x37")])
def test_mc_warp_disp_bwd_kernel_matches_plain(cuda, shape, seed):
    gen = torch.Generator().manual_seed(seed)
    img = _smooth(gen, shape, 3.0, cuda)
    disp = _smooth(gen, (shape[0], 2, *shape[2:]), 15.0, cuda)
    g = torch.randn(shape, generator=gen).to(cuda)
    assert (disp.abs() > 11).any()
    before = LAUNCHES["mc_warp_disp_bwd"]
    out = warp_kernels.mc_warp_disp_bwd(img, disp, g, 12)
    ref = warp_kernels._mc_warp_disp_bwd_plain(img, disp, g, 12)
    torch.cuda.synchronize()
    assert LAUNCHES["mc_warp_disp_bwd"] == before + 1
    _close(out, ref)


@pytest.mark.parametrize("radius", [2, 12])
def test_mc_warp_fused_bwd_kernel_matches_plain(cuda, radius):
    gen = torch.Generator().manual_seed(10 + radius)
    img = _smooth(gen, (6, 2, 40, 36), 3.0, cuda)
    disp = _smooth(gen, (6, 2, 40, 36), 15.0, cuda)
    g = torch.randn((6, 2, 40, 36), generator=gen).to(cuda)
    assert (disp.abs() > radius - 1).any()
    before = LAUNCHES["mc_warp_fused_bwd"]
    outs = warp_kernels.mc_warp_fused_bwd(img, disp, g, radius)
    refs = warp_kernels._mc_warp_fused_bwd_plain(img, disp, g, radius)
    gf, gd = warp_kernels.mc_warp_fused_bwd(img, disp, g, radius,
                                            with_disp=False)
    torch.cuda.synchronize()
    assert LAUNCHES["mc_warp_fused_bwd"] == before + 2 and gd is None
    for out, ref in zip(outs + (gf,), refs + refs[:1]):
        _close(out, ref)
    # autograd of the warp with both inputs needing their gradient
    f, d = img.clone().requires_grad_(), disp.clone().requires_grad_()
    out = warp_kernels.bilinear_warp_banded_multi(f, d, radius=radius)
    for got, ref in zip(torch.autograd.grad((out * g).sum(), (f, d)), refs):
        _close(got, ref)


def _np_smooth(rng, shape, scale):
    """A smooth random float32 field with max |value| = scale (a periodic
    7-tap box blur twice over each axis)."""
    x = rng.normal(size=shape)
    for axis in (-2, -1, -2, -1):
        x = sum(np.roll(x, s, axis=axis) for s in range(-3, 4)) / 7.0
    return (x / np.abs(x).max() * scale).astype(np.float32)


K5_CASES = {
    # kind: (n, h, w, radius)
    "convergent": (3, 40, 36, 12),
    "clip": (3, 40, 36, 12),
    "integer": (3, 40, 36, 8),
    "odd40x36": (6, 40, 36, 12),
    "narrow20x12": (4, 20, 12, 12),
}


def k5_case(kind, channels, seed=0):
    """(field, disp, g, radius) as float32 numpy for one of K5's hard cases:
    ``convergent`` (every source pulled to its item's centre: the clamp then
    lands all sources within radius - 1 px of it on one coordinate, the
    longest lists of sources a tap), ``clip`` (a smooth shift down and right
    of 0.3-0.9 (radius - 1) px: the clip holds whole rows and columns on the
    last row and column, where a0 == a1), ``integer`` (whole-pixel
    displacements, every fraction 0), and smooth 15 px fields on frames that
    are no multiple of the kernel's tile or narrower than a warp."""
    n, h, w, radius = K5_CASES[kind]
    rng = np.random.default_rng(seed)
    field = _np_smooth(rng, (n, channels, h, w), 3.0)
    g = rng.normal(size=(n, channels, h, w)).astype(np.float32)
    r = radius - 1
    if kind == "convergent":
        centre = rng.uniform(-0.5, 0.5, size=(n, 2, 1, 1))
        ii = np.arange(h).reshape(1, h, 1)
        jj = np.arange(w).reshape(1, 1, w)
        disp = np.stack(np.broadcast_arrays(
            (h - 1) / 2 + centre[:, 0] - ii, (w - 1) / 2 + centre[:, 1] - jj),
            axis=1)
    elif kind == "clip":
        disp = _np_smooth(rng, (n, 2, h, w), 0.3 * r) + 0.6 * r
    elif kind == "integer":
        disp = np.round(_np_smooth(rng, (n, 2, h, w), 1.5 * r))
    else:
        disp = _np_smooth(rng, (n, 2, h, w), 15.0)
    return field, disp.astype(np.float32), g, radius


@pytest.mark.parametrize("kind,channels",
                         [(k, 2) for k in K5_CASES] + [("narrow20x12", 3),
                                                       ("convergent", 5)])
def test_mc_warp_fused_bwd_kernel_hard_cases(cuda, kind, channels):
    field, disp, g, radius = (torch.from_numpy(a).to(cuda) if not
                              isinstance(a, int) else a
                              for a in k5_case(kind, channels))
    before = LAUNCHES["mc_warp_fused_bwd"]
    outs = warp_kernels.mc_warp_fused_bwd(field, disp, g, radius)
    again = warp_kernels.mc_warp_fused_bwd(field, disp, g, radius)
    refs = warp_kernels._mc_warp_fused_bwd_plain(field, disp, g, radius)
    torch.cuda.synchronize()
    assert LAUNCHES["mc_warp_fused_bwd"] == before + 2
    for out, rep, ref in zip(outs, again, refs):
        assert torch.equal(out, rep)
        _close(out, ref)


def test_epdiff_step_bwd_kernel_matches_plain(cuda):
    gen = torch.Generator().manual_seed(8)
    v = _smooth(gen, (5, 2, 24, 20), 9.0, cuda)
    m = _smooth(gen, (5, 2, 24, 20), 3.0, cuda)
    u = _smooth(gen, (5, 2, 24, 20), 2.0, cuda)
    gm = torch.randn((5, 2, 24, 20), generator=gen).to(cuda)
    gu = torch.randn((5, 2, 24, 20), generator=gen).to(cuda)
    assert (0.2 * v.abs() > 1).any()
    before = LAUNCHES["epdiff_step_bwd"]
    outs = epdiff_kernels.epdiff_step_bwd(v, m, u, gm, gu, 0.2, 2)
    refs = epdiff_kernels._epdiff_step_bwd_plain(v, m, u, gm, gu, 0.2, 2)
    torch.cuda.synchronize()
    assert LAUNCHES["epdiff_step_bwd"] == before + 1
    for out, ref in zip(outs, refs):
        _close(out, ref)


@pytest.mark.parametrize(
    "shape,radius",
    [(shape, radius)
     for shape in [(5, 2, 24, 20), (3, 2, 17, 45), (2, 2, 4, 4),
                   (190, 2, 64, 64), (1, 2, 40, 36)]
     for radius in (1, 2, 3)]
    + [((3, 2, 64, 64), 16), ((2, 2, 64, 64), 20), ((2, 2, 64, 64), 40),
       ((2, 2, 20, 12), 70)])
def test_epdiff_step_bwd_kernel_tiles_and_radii(cuda, shape, radius):
    """K3's tiled kernel at tile edges, the 4x4 minimum and a 45-px width,
    at the compiled radii 1, 2 and a runtime one (3); its runtime-radius
    kernel also where a tile's sources span several of its chunks (16-40
    px) and where the radius exceeds the plane (70 on 20x12). |dt v|
    reaches radius + 0.4 px, so the clamp bites and, from radius 2, the
    clip; two launches give the same bits."""
    gen = torch.Generator().manual_seed(20 + radius)
    v = _smooth(gen, shape, (radius + 0.4) / 0.2, cuda)
    m = _smooth(gen, shape, 3.0, cuda)
    u = _smooth(gen, shape, 2.0, cuda)
    gm = torch.randn(shape, generator=gen).to(cuda)
    gu = torch.randn(shape, generator=gen).to(cuda)
    b = -0.2 * v
    assert (b.abs() > radius - 1).any()
    if radius > 1:
        ii = torch.arange(shape[-2], device=cuda).view(1, -1, 1)
        cy = ii + b[:, 0].clamp(1 - radius, radius - 1)
        assert ((cy < 0) | (cy > shape[-2] - 1)).any()
    outs = epdiff_kernels.epdiff_step_bwd(v, m, u, gm, gu, 0.2, radius)
    again = epdiff_kernels.epdiff_step_bwd(v, m, u, gm, gu, 0.2, radius)
    refs = epdiff_kernels._epdiff_step_bwd_plain(v, m, u, gm, gu, 0.2,
                                                 radius)
    torch.cuda.synchronize()
    for out, rep, ref in zip(outs, again, refs):
        assert torch.equal(out, rep)
        _close(out, ref)


@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("hw", [(40, 45), (24, 20), (17, 46)])
def test_mc_warp_kernel_ragged_widths(cuda, channels, hw):
    """K1 on widths that are no multiple of 4 (its scalar path) and on one
    that is (its float4 path), clamp and clip biting; two launches give the
    same bits."""
    gen = torch.Generator().manual_seed(30 + channels)
    img = _smooth(gen, (4, channels) + hw, 3.0, cuda)
    disp = _smooth(gen, (4, 2) + hw, 15.0, cuda)
    assert (disp.abs() > 11).any()
    with torch.inference_mode():
        out = warp_kernels.bilinear_warp_banded_multi(img, disp, radius=12)
        again = warp_kernels.bilinear_warp_banded_multi(img, disp, radius=12)
        ref = warp_kernels._mc_warp_plain(img, disp, 12)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    _close(out, ref)


def test_autograd_backward_launches_the_kernels(cuda):
    gen = torch.Generator().manual_seed(9)
    v = _smooth(gen, (3, 2, 16, 16), 6.0, cuda).requires_grad_()
    m = _smooth(gen, (3, 2, 16, 16), 2.0, cuda).requires_grad_()
    u = torch.zeros((3, 2, 16, 16), device=cuda)
    img = _smooth(gen, (3, 1, 16, 16), 1.0, cuda)
    before = (LAUNCHES["epdiff_step_bwd"], LAUNCHES["mc_warp_disp_bwd"])
    m1, u1 = epdiff_kernels.epdiff_step(v, m, u, 0.2, 2)
    out = warp_kernels.bilinear_warp_banded_multi(img, u1 * 4.0, radius=12,
                                                  img_const=True)
    gv, gm = torch.autograd.grad(out.sum() + m1.sum(), (v, m))
    torch.cuda.synchronize()
    assert (LAUNCHES["epdiff_step_bwd"], LAUNCHES["mc_warp_disp_bwd"]) \
        == (before[0] + 1, before[1] + 1)
    # the same graph through the plain versions on the card
    v2, m2 = v.detach().clone().requires_grad_(), m.detach().clone().requires_grad_()
    m1p, u1p = epdiff_kernels._epdiff_step_plain(v2, m2, u, 0.2, 2)
    outp = warp_kernels._mc_warp_plain(img, u1p * 4.0, 12)
    gvp, gmp = torch.autograd.grad(outp.sum() + m1p.sum(), (v2, m2))
    _close(gv, gvp)
    _close(gm, gmp)


def _solve_inputs(gen, shape, cuda, metric=(0.5, 1.0, 2)):
    """m, u, gm', gu' with b = -0.2 K m drawn at least 0.2 px from every
    integer, where K7's masks and taps are discontinuous (the kernel's v and
    the plain version's differ in the last bits), the in-scan clamp biting;
    m = L v solved in float64."""
    _, _, h, w = shape
    b = _smooth(gen, shape, 2.4, "cpu").double()
    b = torch.floor(b) + 0.2 + 0.6 * (b - torch.floor(b))
    ty, tx, spec = (torch.from_numpy(a).double() for a in
                    _helmholtz_mm_weights(h, w, *metric, False))
    m = (ty.T @ ((ty @ (-b / 0.2) @ tx.T) * spec) @ tx).float()
    assert (b.abs() > 1).any()
    u = _smooth(gen, shape, 2.0, cuda)
    gm, gu = (torch.randn(shape, generator=gen).to(cuda) for _ in range(2))
    return m.contiguous().to(cuda), u.contiguous(), gm, gu, \
        epdiff_kernels._solve_operands(h, w, *metric, cuda)


@pytest.mark.parametrize(
    "shape,radius",
    [((6, 2, 40, 36), 2), ((7, 2, 52, 36), 2), ((1, 2, 64, 64), 2),
     ((2, 2, 128, 128), 2), ((2, 2, 4, 4), 2), ((3, 2, 24, 20), 1),
     ((3, 2, 24, 20), 3)])
def test_epdiff_step_solve_kernels_match_plain(cuda, shape, radius):
    """K6 and K7 at planes whose rows do not divide among the cluster's
    16-row bands (40, 52 rows) and whose sides are no multiple of 8, at one
    item, at 128^2 (a cluster of 8), at the 4x4 minimum, at R = 1, 2 and a
    runtime radius (3); two launches give the same bits."""
    gen = torch.Generator().manual_seed(12)
    m, u, gm, gu, ops = _solve_inputs(gen, shape, cuda)
    before = (LAUNCHES["epdiff_step_solve_fwd"],
              LAUNCHES["epdiff_step_solve_bwd"])
    with torch.inference_mode():
        outs, again = (epdiff_kernels.epdiff_step_solve(
            m, u, 0.2, radius, 0.5, 1.0, 2) for _ in range(2))
        refs = epdiff_kernels._epdiff_step_solve_plain(m, u, *ops, 0.2,
                                                       radius)
    gouts, gagain = (epdiff_kernels.epdiff_step_solve_bwd(
        m, u, *ops, gm, gu, 0.2, radius) for _ in range(2))
    grefs = epdiff_kernels._epdiff_step_solve_bwd_plain(m, u, *ops, gm, gu,
                                                        0.2, radius)
    torch.cuda.synchronize()
    assert (LAUNCHES["epdiff_step_solve_fwd"],
            LAUNCHES["epdiff_step_solve_bwd"]) == (before[0] + 2,
                                                   before[1] + 2)
    for out, rep, ref in zip(outs + gouts, again + gagain, refs + grefs):
        assert torch.equal(out, rep)
        _close(out, ref)


def test_epdiff_step_solve_refuses_planes_over_128(cuda):
    """The kernels keep an item in a cluster's shared memory: a plane over
    128 px a side raises before any launch."""
    m = torch.zeros((1, 2, 130, 64), device=cuda)
    ops = epdiff_kernels._solve_operands(130, 64, 0.5, 1.0, 2, cuda)
    with pytest.raises(ValueError, match="128"):
        epdiff_kernels.epdiff_step_solve(m, m, 0.2, 2, 0.5, 1.0, 2)
    with pytest.raises(ValueError, match="128"):
        epdiff_kernels.epdiff_step_solve_bwd(m, m, *ops, m, m, 0.2, 2)


def test_epdiff_step_solve_backward_launches_k7_once(cuda):
    gen = torch.Generator().manual_seed(13)
    m, u, gm, gu, ops = _solve_inputs(gen, (3, 2, 24, 20), cuda)
    m, u = m.requires_grad_(), u.requires_grad_()
    before = LAUNCHES["epdiff_step_solve_bwd"]
    mo, uo = epdiff_kernels.epdiff_step_solve(m, u, 0.2, 2, 0.5, 1.0, 2)
    got = torch.autograd.grad((mo * gm).sum() + (uo * gu).sum(), (m, u))
    torch.cuda.synchronize()
    assert LAUNCHES["epdiff_step_solve_bwd"] == before + 1
    refs = epdiff_kernels._epdiff_step_solve_bwd_plain(
        m.detach(), u.detach(), *ops, gm, gu, 0.2, 2)
    for out, ref in zip(got, refs):
        _close(out, ref)


def test_expmap_shooting_fused_solve_launches_k6(cuda, monkeypatch):
    monkeypatch.setattr(shooting, "_FUSED_SOLVE", True)
    gen = torch.Generator().manual_seed(14)
    m0 = _smooth(gen, (3, 2, 32, 32), 20.0, cuda).contiguous()
    before = (LAUNCHES["epdiff_step_solve_fwd"], LAUNCHES["epdiff_step_fwd"])
    with torch.inference_mode():
        u, _ = shooting.expmap_shooting(m0, n_steps=3, warp_radius=8)
    torch.cuda.synchronize()
    assert (LAUNCHES["epdiff_step_solve_fwd"], LAUNCHES["epdiff_step_fwd"]) \
        == (before[0] + 3, before[1])
    assert torch.isfinite(u).all()


def _small_joint_cfg():
    """The flagship at 32^2 with T = 4 (3 pairs) and Ts = 8, its
    reconstruction loss alone."""
    return {
        "networks": {
            "joint_register_strainmat": {
                "type": "JointRegisterStrainMatNet",
                "strainmat_net_type": "ResNet3D", "n_strain_matrix_frames": 8,
                "strainmat_smoothing_method": "SVD",
                "strainmat_smoothing_SVD_rank": 5, "reg_features": 8,
                "n_integration_steps": 2, "reg_half_res": False},
            "LMA": {"type": "NetStrainMat2LMA", "num_conv_layers": 2,
                    "inner_conv_channel_num": 8, "n_frames": 8}},
        "training": {"scheme": "joint_registration_strainmat_LMA",
                     "seed": 3, "optimizers": {
                         n: {"type": "Adam", "learning_rate": 1e-3,
                             "lr_scheduler": {"enable": True,
                                              "type": "CosineAnnealingLR",
                                              "T_max": 2, "eta_min": 1e-4}}
                         for n in ("joint_register_strainmat", "LMA")}},
        "losses": {"registration_reconstruction": {
            "criterion": "registration_reconstruction",
            "prediction": "various", "target": "registration_target",
            "weight": 1.0, "sigma": 0.03, "regularization_weight": 0.1}},
    }


def test_train_step_graph_replay_matches_eager_step(cuda):
    """The fused epoch on the card (``train.graphs``): the train step
    warmed up, captured and replayed over a device-resident dataset gives
    the step loop's loss values, parameters and optimizer state bit for bit
    under PyTorch's deterministic mode (``device.deterministic``: cuDNN's
    backward may otherwise sum in another order from run to run), and the
    launch counters hold what the device ran (K2 n_steps x Euler steps a
    batch, K1/K4 one a batch) though a replay runs no Python."""
    import copy

    from cardiax_torch.data.datasets import JointDataset
    from cardiax_torch.data.loader import DeviceBatcher
    from cardiax_torch.data.synthetic import make_dataset
    from cardiax_torch.models import build_model
    from cardiax_torch.train import build_trainer
    from cardiax_torch.train.graphs import EpochRunner
    cfg = _small_joint_cfg()
    ds = JointDataset(make_dataset(n_subjects=4, slices_per_subject=1, h=32,
                                   w=32, n_frames=4, seed=1),
                      dataset_config={"n_myo_frames_to_use_for_regression": 4,
                                      "n_strainmat_frames_to_use_for_regression": 8})
    nets = {n: build_model(mc, n_pairs=3) for n, mc in cfg["networks"].items()}
    engines = []
    for _ in range(2):
        eng = build_trainer(cfg["training"], "cuda", cfg)
        eng.setup(copy.deepcopy(nets), None, 2)
        engines.append(eng)
    graph_eng, loop_eng = engines
    with deterministic():
        loader = DeviceBatcher(ds, 2, shuffle=True, seed=3, device=cuda)
        runner = EpochRunner(loader, graph_eng._update,
                             after_step=graph_eng._schedules_step)
        before = (LAUNCHES["epdiff_step_fwd"], LAUNCHES["mc_warp_fwd"],
                  LAUNCHES["mc_warp_disp_bwd"])
        graph_vals = []
        for _ in range(3):    # warm-up step, capture, then replays only
            idx, mask = loader.epoch_plan()
            graph_vals.append(runner(idx, mask)[:, list(runner.keys).index(
                "total_loss")].clone())
        torch.cuda.synchronize()
        assert runner.graph.graph is not None and runner.graph.replays == 5
        assert (LAUNCHES["epdiff_step_fwd"] - before[0],
                LAUNCHES["mc_warp_fwd"] - before[1],
                LAUNCHES["mc_warp_disp_bwd"] - before[2]) == (6 * 2, 6, 6)
        loop_vals, plan = [], DeviceBatcher(ds, 2, shuffle=True, seed=3,
                                            device=cuda)
        for _ in range(3):
            loop_vals.append(torch.stack([
                loop_eng.train_step(loop_eng.to_device(batch))["total_loss"]
                for batch in plan]))
    got, want = torch.cat(graph_vals), torch.cat(loop_vals)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want), (got, want)
    for name, module in graph_eng.modules.items():
        ref = loop_eng.modules[name].state_dict()
        for k, v in module.state_dict().items():
            assert torch.equal(v, ref[k]), (name, k)
        opt_g = graph_eng.optimizers[name][0].state_dict()
        opt_l = loop_eng.optimizers[name][0].state_dict()
        assert opt_g["state"].keys() == opt_l["state"].keys()
        for i, slots in opt_g["state"].items():
            for k, v in slots.items():
                assert torch.equal(v, opt_l["state"][i][k]), (name, i, k)


def test_step_graph_captures_with_the_cycle_collector_off(cuda):
    """A collection during a capture can destroy an unreachable earlier
    graph, which CUDA refuses then: ``StepGraph`` captures with Python's
    cycle collector off and turns it back on."""
    from cardiax_torch.train.graphs import StepGraph
    x = torch.zeros(8, device=cuda)
    seen = []

    def step():
        seen.append(gc.isenabled())
        return x + 1

    graph = StepGraph(step, cuda)
    outs = [graph() for _ in range(3)]    # warm-up, capture, replay
    torch.cuda.synchronize()
    assert seen == [True, False] and gc.isenabled()
    assert all(torch.equal(o, torch.ones_like(x)) for o in outs)


def saved_tensor_bytes(path):
    """A checkpoint file's tensor bytes: (all of them, the training
    state's), the second without ``extra``, whose generator states are
    born on the CPU."""
    state = torch.load(path, map_location="cpu", weights_only=True)

    def size(tree):
        if isinstance(tree, torch.Tensor):
            return tree.nbytes
        if isinstance(tree, dict):
            return sum(size(v) for v in tree.values())
        if isinstance(tree, (list, tuple)):
            return sum(size(v) for v in tree)
        return 0
    return size(state), size({k: v for k, v in state.items()
                              if k != "extra"})


def test_host_recorder_counts_graphs_and_checkpoint_bytes(cuda, tmp_path):
    """``training.host_profile`` on the card: each fused runner's
    ``StepGraph`` captures once, in epoch 0 (``dispatch.captures`` 2 there,
    for the train and val runners, then 0), ``dispatch.steps`` counts
    every call, ``ckpt.bytes_to_host`` is the saved training state's bytes
    (the generators' states, born on the CPU, left out), and one ``test``
    call of two batches records one ``graph.warmup`` and one
    ``graph.capture`` span."""
    from cardiax_torch.data.datasets import JointDataset
    from cardiax_torch.data.synthetic import make_dataset
    from cardiax_torch.io import profiling
    from cardiax_torch.models import build_model
    from cardiax_torch.train import build_trainer
    cfg = _small_joint_cfg()
    cfg["training"].update(batch_size=3, epochs=3, host_profile=True)
    cfg["saving"] = {"saving_dir": str(tmp_path), "save_checkpoint": True}
    data = make_dataset(n_subjects=10, slices_per_subject=1, h=32, w=32,
                        n_frames=4, seed=1)
    ds_cfg = {"n_myo_frames_to_use_for_regression": 4,
              "n_strainmat_frames_to_use_for_regression": 8}
    # 6 train and 4 val slices at batch 3: two steps each an epoch
    datasets = {"train": JointDataset(data[:6], dataset_config=ds_cfg),
                "val": JointDataset(data[6:], dataset_config=ds_cfg)}
    nets = {n: build_model(mc, n_pairs=3) for n, mc in cfg["networks"].items()}
    eng = build_trainer(cfg["training"], "cuda", cfg)
    exp, _ = eng.train(nets, datasets)
    assert eng.last_fuse_trainval is True
    rows = eng.host_profile_rows
    assert [r["dispatch.captures"] for r in rows] == [2, 0, 0]
    assert [r["dispatch.steps"] for r in rows] == [4, 4, 4]
    assert [r.graph.captures for r in eng._runners.values()] == [1, 1]
    total, state = saved_tensor_bytes(
        tmp_path / "checkpoints" / "epoch_000002.pt")
    assert 0 < state < total
    assert all(r["ckpt.bytes_to_host"] == state for r in rows)
    assert all(0 < r["ckpt.to_host"] + r["ckpt.wait"] <= r["ckpt"]
               and r["ckpt.write"] > 0 for r in rows)
    eng.test(exp, {"test": datasets["val"]},
             trainer_config=cfg["training"])
    rec = profiling.RECORDER
    assert len(rec.named("graph.warmup")) == len(rec.named("graph.capture")) \
        == 1


def test_prefetch_batcher_on_the_card_gives_the_host_batches(cuda):
    """``PrefetchBatcher``'s CUDA path (pinned buffers, side-stream copies,
    an event a batch): every numeric field on the card, equal to the host
    loader's batch copied there; the non-numeric fields pass through; the
    consumer's work on a batch sees its copy (a step that reads each batch
    right away gives the host batches' sums); a worker error re-raises."""
    from cardiax_torch.data.loader import Batcher
    from cardiax_torch.data.prefetch import PrefetchBatcher
    rng = np.random.default_rng(0)
    items = [{"x": rng.standard_normal((64, 64)).astype(np.float32),
              "k": np.full((2,), i, np.int64), "name": f"item{i}"}
             for i in range(7)]
    host = list(Batcher(items, 3, shuffle=True, seed=1))
    got = list(PrefetchBatcher(Batcher(items, 3, shuffle=True, seed=1),
                               cuda, depth=2))
    assert len(got) == len(host) == 3
    sums = []
    for a, b in zip(got, host):
        assert a.keys() == b.keys()
        assert a["x"].is_cuda and a["k"].is_cuda
        assert torch.equal(a["x"].cpu(), torch.from_numpy(b["x"]))
        assert torch.equal(a["k"].cpu(), torch.from_numpy(b["k"]))
        assert list(a["name"]) == list(b["name"])
        sums.append(a["x"].double().sum())
    torch.cuda.synchronize()
    assert [float(x) for x in sums] == [float(b["x"].astype(np.float64)
                                              .sum()) for b in host]

    class Broken:
        def __len__(self):
            return 2

        def __iter__(self):
            yield host[0]
            raise RuntimeError("worker failed")

    with pytest.raises(RuntimeError, match="worker failed"):
        list(PrefetchBatcher(Broken(), cuda))

