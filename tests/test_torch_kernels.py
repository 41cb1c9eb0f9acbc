"""The port's CUDA kernels against their plain PyTorch versions, on the card.

K1/K2 are the forward warp and EPDiff step, K4/K3 their backward kernels,
K5 the warp's full backward (d/d field and d/d disp); one test per autograd
Function checks that a backward through autograd on the card launches its
kernel.

Marked ``gpu``: without a CUDA device each test skips (decided inside the
fixture, not at import). On a machine with an H100 run
``python -m pytest tests/test_torch_kernels.py``; the kernels build from
``cardiax_torch/csrc`` on first use. Tolerance: f32, 1e-5 relative to the
output's largest magnitude (the kernel may contract a*b+c into one fma
where the plain version rounds twice).
"""

import numpy as np
import pytest
import torch

from cardiax_torch.ops import epdiff_kernels, warp_kernels

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
    before = warp_kernels.launches
    with torch.inference_mode():
        out = warp_kernels.bilinear_warp_banded_multi(img, disp, radius=12)
        ref = warp_kernels._mc_warp_plain(img, disp, 12)
    torch.cuda.synchronize()
    assert warp_kernels.launches == before + 1
    _close(out, ref)


def test_epdiff_step_kernel_matches_plain(cuda):
    gen = torch.Generator().manual_seed(0)
    v = _smooth(gen, (5, 2, 24, 20), 9.0, cuda)
    m = _smooth(gen, (5, 2, 24, 20), 3.0, cuda)
    u = _smooth(gen, (5, 2, 24, 20), 2.0, cuda)
    assert (0.2 * v.abs() > 1).any()
    before = epdiff_kernels.launches
    with torch.inference_mode():
        mk, uk = epdiff_kernels.epdiff_step(v, m, u, 0.2, 2)
        mr, ur = epdiff_kernels._epdiff_step_plain(v, m, u, 0.2, 2)
    torch.cuda.synchronize()
    assert epdiff_kernels.launches == before + 1
    _close(mk, mr)
    _close(uk, ur)
    assert np.isfinite(uk.cpu().numpy()).all()


def test_mc_warp_disp_bwd_kernel_matches_plain(cuda):
    gen = torch.Generator().manual_seed(7)
    img = _smooth(gen, (6, 2, 40, 36), 3.0, cuda)
    disp = _smooth(gen, (6, 2, 40, 36), 15.0, cuda)
    g = torch.randn((6, 2, 40, 36), generator=gen).to(cuda)
    assert (disp.abs() > 11).any()
    before = warp_kernels.bwd_launches
    out = warp_kernels.mc_warp_disp_bwd(img, disp, g, 12)
    ref = warp_kernels._mc_warp_disp_bwd_plain(img, disp, g, 12)
    torch.cuda.synchronize()
    assert warp_kernels.bwd_launches == before + 1
    _close(out, ref)


@pytest.mark.parametrize("radius", [2, 12])
def test_mc_warp_fused_bwd_kernel_matches_plain(cuda, radius):
    gen = torch.Generator().manual_seed(10 + radius)
    img = _smooth(gen, (6, 2, 40, 36), 3.0, cuda)
    disp = _smooth(gen, (6, 2, 40, 36), 15.0, cuda)
    g = torch.randn((6, 2, 40, 36), generator=gen).to(cuda)
    assert (disp.abs() > radius - 1).any()
    before = warp_kernels.fused_bwd_launches
    outs = warp_kernels.mc_warp_fused_bwd(img, disp, g, radius)
    refs = warp_kernels._mc_warp_fused_bwd_plain(img, disp, g, radius)
    gf, gd = warp_kernels.mc_warp_fused_bwd(img, disp, g, radius,
                                            with_disp=False)
    torch.cuda.synchronize()
    assert warp_kernels.fused_bwd_launches == before + 2 and gd is None
    for out, ref in zip(outs + (gf,), refs + refs[:1]):
        _close(out, ref)
    # autograd of the warp with both inputs needing their gradient
    f, d = img.clone().requires_grad_(), disp.clone().requires_grad_()
    out = warp_kernels.bilinear_warp_banded_multi(f, d, radius=radius)
    for got, ref in zip(torch.autograd.grad((out * g).sum(), (f, d)), refs):
        _close(got, ref)


def test_epdiff_step_bwd_kernel_matches_plain(cuda):
    gen = torch.Generator().manual_seed(8)
    v = _smooth(gen, (5, 2, 24, 20), 9.0, cuda)
    m = _smooth(gen, (5, 2, 24, 20), 3.0, cuda)
    u = _smooth(gen, (5, 2, 24, 20), 2.0, cuda)
    gm = torch.randn((5, 2, 24, 20), generator=gen).to(cuda)
    gu = torch.randn((5, 2, 24, 20), generator=gen).to(cuda)
    assert (0.2 * v.abs() > 1).any()
    before = epdiff_kernels.bwd_launches
    outs = epdiff_kernels.epdiff_step_bwd(v, m, u, gm, gu, 0.2, 2)
    refs = epdiff_kernels._epdiff_step_bwd_plain(v, m, u, gm, gu, 0.2, 2)
    torch.cuda.synchronize()
    assert epdiff_kernels.bwd_launches == before + 1
    for out, ref in zip(outs, refs):
        _close(out, ref)


def test_autograd_backward_launches_the_kernels(cuda):
    gen = torch.Generator().manual_seed(9)
    v = _smooth(gen, (3, 2, 16, 16), 6.0, cuda).requires_grad_()
    m = _smooth(gen, (3, 2, 16, 16), 2.0, cuda).requires_grad_()
    u = torch.zeros((3, 2, 16, 16), device=cuda)
    img = _smooth(gen, (3, 1, 16, 16), 1.0, cuda)
    before = (epdiff_kernels.bwd_launches, warp_kernels.bwd_launches)
    m1, u1 = epdiff_kernels.epdiff_step(v, m, u, 0.2, 2)
    out = warp_kernels.bilinear_warp_banded_multi(img, u1 * 4.0, radius=12,
                                                  img_const=True)
    gv, gm = torch.autograd.grad(out.sum() + m1.sum(), (v, m))
    torch.cuda.synchronize()
    assert (epdiff_kernels.bwd_launches, warp_kernels.bwd_launches) \
        == (before[0] + 1, before[1] + 1)
    # the same graph through the plain versions on the card
    v2, m2 = v.detach().clone().requires_grad_(), m.detach().clone().requires_grad_()
    m1p, u1p = epdiff_kernels._epdiff_step_plain(v2, m2, u, 0.2, 2)
    outp = warp_kernels._mc_warp_plain(img, u1p * 4.0, 12)
    gvp, gmp = torch.autograd.grad(outp.sum() + m1p.sum(), (v2, m2))
    _close(gv, gvp)
    _close(gm, gmp)
