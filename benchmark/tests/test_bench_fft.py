"""The reference's FFT forms of the fluid metric and the resize, which it
takes above 128 px, against its dense forms called at the same sides:
values and the gradient that autograd takes through them, within 1e-5 of
the dense form's largest magnitude."""

import pytest
import torch

from reference import ops as rops


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _both(fft, dense, x):
    """Each form's output and its input gradient for the same cotangent."""
    x = x.clone().requires_grad_(True)
    out = []
    for f in (fft, dense):
        y = f(x)
        g = torch.randn(y.shape, generator=torch.Generator().manual_seed(3))
        out.append((y.detach(), torch.autograd.grad(y, x, g)[0]))
    return out


@pytest.mark.parametrize("hw", [(136, 80), (160, 144), (133, 96)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_sharp_fft_equals_dense(hw):
    m = torch.randn(3, 2, *hw, generator=torch.Generator().manual_seed(1))
    assert max(hw) > rops.DENSE_MAX_SIDE
    (yf, gf), (yd, gd) = _both(
        lambda x: rops.sharp(x, 2.0, 1.0, 2),
        lambda x: rops._sharp_dense(x, 2.0, 1.0, 2), m)
    assert _gap(yf, yd) <= 1e-5
    assert _gap(gf, gd) <= 1e-5


# (in, out) a side: down and up with the smaller grid even (its Nyquist
# folded, or split in halves), odd, and one side's length unchanged
@pytest.mark.parametrize("hw, out", [
    ((136, 80), (272, 160)), ((272, 160), (136, 80)), ((160, 144), (80, 72)),
    ((133, 97), (266, 194)), ((266, 194), (133, 97)), ((135, 80), (270, 81)),
    ((270, 81), (135, 80)), ((144, 130), (144, 65))],
    ids=lambda v: f"{v[0]}x{v[1]}")
def test_resize_fft_equals_dense(hw, out):
    x = torch.randn(2, 2, *hw, generator=torch.Generator().manual_seed(2))
    assert max(*hw, *out) > rops.DENSE_MAX_SIDE
    (yf, gf), (yd, gd) = _both(lambda v: rops.spectral_resize(v, out),
                               lambda v: rops._resize_dense(v, out), x)
    assert yf.shape == yd.shape == (2, 2, *out)
    assert _gap(yf, yd) <= 1e-5
    assert _gap(gf, gd) <= 1e-5


def test_control_rounds_the_fft_forms():
    """The control (bfloat16 results) departs from the exact FFT forms by
    about bfloat16's rounding, as it does from the dense ones."""
    m = torch.randn(2, 2, 160, 144, generator=torch.Generator().manual_seed(4))
    low = rops.Numerics(lowp=True)
    exact = rops.sharp(m, 2.0, 1.0, 2)
    assert 1e-4 < _gap(rops.sharp(m, 2.0, 1.0, 2, low), exact) < 2e-2
    up = rops.spectral_resize(m, (320, 288))
    assert 1e-4 < _gap(rops.spectral_resize(m, (320, 288), low), up) < 2e-2
