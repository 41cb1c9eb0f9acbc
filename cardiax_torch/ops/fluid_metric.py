"""Fluid metric K = (gamma - alpha*Lap)^(-power) and band-limited resize.

Counterpart of ``cardiax/ops/fluid_metric.py``: ``helmholtz_spectrum``,
``_real_dft_basis``, ``sharp`` (v = K m), ``flat`` (m = L v),
``_band_resize_matrix``, ``spectral_resize``, ``solve_mm_operands`` and
``FluidMetric``. The spectrum is that of the discrete 5-point Laplacian.
Sides up to ``_MM_MAX_SIDE`` run as real-DFT matmuls (float32, no TF32:
``cardiax_torch.device.set_numerics``), larger ones through ``rfft2``.
``solve_mm_operands`` hands the same matmul operands to the fused-solve
EPDiff kernel (K6/K7), which runs the four products in its own body. The
lane-packed TPU variants (``sharp_packed`` and the block-diagonal bases of
``_helmholtz_mm_weights_packed``) are not ported: the port does not pack
items.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

_MM_MAX_SIDE = 128

# per-device copies of the constant bases, keyed by (device, what, shape args)
_device_consts: Dict[tuple, torch.Tensor] = {}


def _const(device: torch.device, key: tuple, make) -> torch.Tensor:
    """``make()`` (a host array) on ``device``, built once per key."""
    k = (str(device),) + key
    t = _device_consts.get(k)
    if t is None:
        # a normal tensor even when first built under inference_mode, so a
        # later autograd caller may save it for backward
        with torch.inference_mode(False):
            t = torch.as_tensor(make()).to(device)
        # under torch.export's tracing the tensor is fake and the program
        # keeps it as a constant; only real tensors may outlive the trace
        if not torch.compiler.is_compiling():
            _device_consts[k] = t
    return t


def helmholtz_spectrum(h: int, w: int, alpha: float = 2.0, gamma: float = 1.0,
                       power: int = 2, device=None) -> torch.Tensor:
    """Eigenvalues of L = (gamma - alpha*Laplacian)^power on the rfft2 grid,
    shape (H, W//2+1), float32."""
    ky = torch.arange(h, dtype=torch.float32, device=device)
    kx = torch.arange(w // 2 + 1, dtype=torch.float32, device=device)
    lam_y = 2.0 - 2.0 * torch.cos(2.0 * np.pi * ky / h)
    lam_x = 2.0 - 2.0 * torch.cos(2.0 * np.pi * kx / w)
    lam = lam_y[:, None] + lam_x[None, :]
    return (gamma + alpha * lam) ** power


@functools.lru_cache(maxsize=None)
def _real_dft_basis(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Orthonormal real DFT basis (n, n) float32 + per-row integer frequency.

    Rows: k=0 constant; for 0<k<n/2 a (cos, sin) pair at frequency k; for
    even n a Nyquist alternating row. T @ T^T = I.
    """
    j = np.arange(n)
    rows, freqs = [np.full(n, 1.0 / np.sqrt(n))], [0]
    for k in range(1, (n + 1) // 2):
        rows.append(np.sqrt(2.0 / n) * np.cos(2 * np.pi * k * j / n))
        rows.append(np.sqrt(2.0 / n) * np.sin(2 * np.pi * k * j / n))
        freqs += [k, k]
    if n % 2 == 0:
        rows.append(np.cos(np.pi * j) / np.sqrt(n))
        freqs.append(n // 2)
    return np.stack(rows).astype(np.float32), np.asarray(freqs)


@functools.lru_cache(maxsize=None)
def _helmholtz_mm_weights(h: int, w: int, alpha: float, gamma: float,
                          power: int, inverse: bool):
    ty, fy = _real_dft_basis(h)
    tx, fx = _real_dft_basis(w)
    lam = (2.0 - 2.0 * np.cos(2 * np.pi * fy / h))[:, None] \
        + (2.0 - 2.0 * np.cos(2 * np.pi * fx / w))[None, :]
    spec = (gamma + alpha * lam) ** power
    wgt = (1.0 / spec if inverse else spec).astype(np.float32)
    return ty, tx, wgt


def _mm_operands(h: int, w: int, alpha: float, gamma: float, power: int,
                 inverse: bool, device):
    """(ty, tx, wgt) of ``_helmholtz_mm_weights`` as cached device
    constants."""
    key = (h, w, float(alpha), float(gamma), int(power), inverse)
    return tuple(_const(torch.device(device), ("mm", i) + key,
                        lambda i=i: _helmholtz_mm_weights(*key)[i])
                 for i in range(3))


def solve_mm_operands(h_item: int, w_item: int, pr: int = 1, pc: int = 1,
                      alpha: float = 2.0, gamma: float = 1.0, power: int = 2,
                      *, device="cpu"):
    """(ty (H, H), txT (W, W), tyT (H, H), tx (W, W), wgt (H, W)) float32
    on ``device``: JAX's operands of the matmul-form solve
    v = Ty^T [ (Ty m Tx^T) * W ] Tx on one (H, W) item. The fused-solve
    EPDiff kernels (K6/K7) take ``ty``, ``tx`` and ``wgt`` and read the
    transposes as index swaps. ``pr``/``pc`` > 1 ask for JAX's
    block-diagonal bases of lane-packed planes, a TPU layout the port does
    not use, and raise."""
    if pr != 1 or pc != 1:
        raise ValueError(f"solve_mm_operands: pr={pr}, pc={pc}: lane-packed "
                         f"planes are a TPU layout, not ported; use 1, 1")
    ty, tx, wgt = _mm_operands(h_item, w_item, alpha, gamma, power, True,
                               device)
    return ty, tx.T, ty.T, tx, wgt


def _helmholtz_mm(x: torch.Tensor, alpha: float, gamma: float, power: int,
                  inverse: bool) -> torch.Tensor:
    """Ty^T [ (Ty x Tx^T) * W ] Tx on (..., H, W)."""
    h, w = x.shape[-2:]
    ty, tx, wgt = _mm_operands(h, w, alpha, gamma, power, inverse, x.device)
    xh = ty @ x.float() @ tx.T
    return ty.T @ (xh * wgt) @ tx


def sharp(momentum: torch.Tensor, alpha: float = 2.0, gamma: float = 1.0,
          power: int = 2) -> torch.Tensor:
    """velocity = K momentum (smoothing). momentum (..., H, W)."""
    h, w = momentum.shape[-2:]
    if max(h, w) <= _MM_MAX_SIDE:
        return _helmholtz_mm(momentum, alpha, gamma, power, inverse=True)
    spec = helmholtz_spectrum(h, w, alpha, gamma, power, momentum.device)
    f = torch.fft.rfft2(momentum.float())
    return torch.fft.irfft2(f / spec, s=(h, w))


def flat(velocity: torch.Tensor, alpha: float = 2.0, gamma: float = 1.0,
         power: int = 2) -> torch.Tensor:
    """momentum = L velocity (the inverse of `sharp`)."""
    h, w = velocity.shape[-2:]
    if max(h, w) <= _MM_MAX_SIDE:
        return _helmholtz_mm(velocity, alpha, gamma, power, inverse=False)
    spec = helmholtz_spectrum(h, w, alpha, gamma, power, velocity.device)
    f = torch.fft.rfft2(velocity.float())
    return torch.fft.irfft2(f * spec, s=(h, w))


class FluidMetric:
    """Bundles (alpha, gamma, power); mirrors lagomorph's FluidMetric object
    (``cardiax/ops/fluid_metric.py:FluidMetric``)."""

    def __init__(self, alpha: float = 2.0, gamma: float = 1.0, power: int = 2):
        self.alpha = float(alpha)
        self.gamma = float(gamma)
        self.power = int(power)

    def sharp(self, m: torch.Tensor) -> torch.Tensor:
        return sharp(m, self.alpha, self.gamma, self.power)

    def flat(self, v: torch.Tensor) -> torch.Tensor:
        return flat(v, self.alpha, self.gamma, self.power)


@functools.lru_cache(maxsize=None)
def _band_resize_matrix(n1: int, n2: int) -> np.ndarray:
    """(n2, n1) float32 matrix of the 1D symmetric band-limited resize.

    Frequencies strictly inside the shared band copy verbatim; the band-edge
    (Nyquist of the smaller, even grid) splits/folds with weight 1/2 per sign
    so the operator is conjugate-symmetric, and the 2D resize is the exact
    tensor product Ry (x) Rx.
    """
    f = np.fft.fft(np.eye(n1), axis=0)            # row r = frequency r
    g = np.zeros((n2, n1), complex)
    k = min(n1, n2) // 2
    g[:k] = f[:k]                                  # freqs 0 .. k-1
    if k > 1:
        g[n2 - k + 1:] = f[n1 - k + 1:]            # freqs -(k-1) .. -1
    if min(n1, n2) == 1:                           # degenerate: DC only
        g[0] = f[0]
    elif min(n1, n2) % 2:                          # odd band edge: +/-k both fit
        g[k] = f[k]
        g[n2 - k] = f[n1 - k]
    elif n2 < n1:                                  # fold +/-k into out Nyquist
        g[k] = 0.5 * (f[k] + f[n1 - k])
    elif n2 > n1:                                  # split in Nyquist into +/-k
        g[k] = 0.5 * f[k]
        g[n2 - k] = 0.5 * f[k]
    else:                                          # same size: identity
        g[k] = f[k]
    return (np.fft.ifft(g, axis=0).real * (n2 / n1)).astype(np.float32)


def _band_axis(f: torch.Tensor, n: int, n2: int) -> torch.Tensor:
    """The symmetric band rule of `_band_resize_matrix` on the full-FFT axis
    -2 of a spectrum (..., n, K) -> (..., n2, K)."""
    k = min(n, n2) // 2
    out = f.new_zeros(f.shape[:-2] + (n2, f.shape[-1]))
    out[..., :k, :] = f[..., :k, :]
    if k > 1:
        out[..., n2 - k + 1:, :] = f[..., n - k + 1:, :]
    if min(n, n2) == 1:
        out[..., 0, :] = f[..., 0, :]
    elif min(n, n2) % 2:
        out[..., k, :] = f[..., k, :]
        out[..., n2 - k, :] = f[..., n - k, :]
    elif n2 < n:
        out[..., k, :] = 0.5 * (f[..., k, :] + f[..., n - k, :])
    elif n2 > n:
        out[..., k, :] = 0.5 * f[..., k, :]
        out[..., n2 - k, :] = 0.5 * f[..., k, :]
    else:
        out[..., k, :] = f[..., k, :]
    return out


def spectral_resize(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Band-limited resampling of (..., H, W) fields (value-preserving for
    signals inside the target band; symmetric band-edge Nyquist split/fold).
    Sides up to ``_MM_MAX_SIDE`` run as two real matmuls, larger ones through
    ``rfft2`` with the same semantics."""
    h, w = x.shape[-2:]
    h2, w2 = out_hw
    if max(h, w, h2, w2) <= _MM_MAX_SIDE and min(h, w, h2, w2) >= 2:
        ry = _const(x.device, ("resize", h, h2),
                    lambda: _band_resize_matrix(h, h2))
        rx = _const(x.device, ("resize", w, w2),
                    lambda: _band_resize_matrix(w, w2))
        return ry @ x.float() @ rx.T
    f = torch.fft.rfft2(x.float())
    out = _band_axis(f, h, h2)
    # cols: rfft half-spectrum axis; the negative-sign partner of a stored
    # coefficient is conj at the mirrored row, f_full[r, -c] = conj(f[-r, c])
    kx = min(w, w2) // 2
    out2 = out.new_zeros(out.shape[:-1] + (w2 // 2 + 1,))
    out2[..., :, :kx] = out[..., :, :kx]
    if min(w, w2) == 1:
        out2[..., :, 0] = out[..., :, 0]
    elif min(w, w2) % 2:
        out2[..., :, kx] = out[..., :, kx]
    elif w2 < w:
        mirrored = torch.roll(torch.flip(out, dims=(-2,)), 1, dims=-2)
        out2[..., :, kx] = 0.5 * (out[..., :, kx]
                                  + torch.conj(mirrored[..., :, kx]))
    elif w2 > w:
        out2[..., :, kx] = 0.5 * out[..., :, kx]
    else:
        out2[..., :, kx] = out[..., :, kx]
    y = torch.fft.irfft2(out2, s=(h2, w2))
    return y * (h2 * w2) / (h * w)
