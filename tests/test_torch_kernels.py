"""The port's CUDA kernels against their plain PyTorch versions, on the card.

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
