"""Plain PyTorch operators of the cardiac registration path.

The benchmark's own reference: the fluid metric v = K m, the band-limited
spectral resize, the clamped bilinear warp, one EPDiff Euler step,
geodesic shooting and the rank-k subspace smoothing of a strain matrix.
Every function is a forward in plain tensor operations; gradients come
from autograd, so no hand-written adjoint is trusted here. Nothing of the
program under test is imported.

The metric and the resize run as real-DFT matmuls where every side is at
most ``DENSE_MAX_SIDE`` (128) px, and through ``torch.fft.rfft2`` /
``irfft2`` (the same spectrum, the same band rule) above it. At 768x512
frames (a 384x256 shooting grid) the dense form would add 3.33 TFLOP of
matmuls to a batch-10 step that counts 4.39 TFLOP without them, and
``tools/count_flops.py`` (``FlopCounterMode``) would count them as model
work that the program, which takes ``rfft2`` there too, does not do.
``FlopCounterMode`` has no formula for an FFT, so the FFT form counts
nothing; its true cost, about 2.5 N log2 N FLOPs a real transform of N
points, is about 52 GFLOP in that step's forward and as much in its
backward: about 2.4% of the step, left out of the count. ``_sharp_dense``
and ``_resize_dense`` keep the dense form callable at any side, so that a
test can hold the two forms against each other.

``Numerics`` is the precision the reference computes in. ``Numerics()``
is float32 where the configuration states float32 (TF32 off, set by the
caller). ``Numerics(lowp=True)`` is the control: every float32 result of
these operators and of the float32 layers is rounded to bfloat16 (and, in
the backward, every cotangent that crosses such a rounding), as a
bfloat16 computation with float32 accumulation would give.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch


class Numerics:
    """``num(x)``: x as the configured precision leaves it; in the control
    (``lowp``) a float32 tensor is rounded to bfloat16."""

    def __init__(self, lowp: bool = False):
        self.lowp = bool(lowp)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.lowp and x.dtype == torch.float32:
            return x.to(torch.bfloat16).to(torch.float32)
        return x


EXACT = Numerics()

# the largest side the metric and the resize take as dense matmuls
DENSE_MAX_SIDE = 128


# ---- fluid metric -------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def real_dft_basis(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Orthonormal real DFT basis (n, n) and each row's integer frequency:
    the constant row, a (cos, sin) pair for 0 < k < n/2, and for even n the
    alternating Nyquist row."""
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
def _metric_operands(h: int, w: int, alpha: float, gamma: float,
                     power: int) -> Tuple[np.ndarray, ...]:
    """(Ty, Tx, 1 / spectrum) of K = (gamma - alpha * Lap)^-power, the
    5-point Laplacian's eigenvalues on the real DFT basis."""
    ty, fy = real_dft_basis(h)
    tx, fx = real_dft_basis(w)
    lam = (2.0 - 2.0 * np.cos(2 * np.pi * fy / h))[:, None] \
        + (2.0 - 2.0 * np.cos(2 * np.pi * fx / w))[None, :]
    return ty, tx, (1.0 / (gamma + alpha * lam) ** power).astype(np.float32)


def _on(x: torch.Tensor, arr: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(arr, device=x.device)


def sharp(m: torch.Tensor, alpha: float, gamma: float, power: int,
          num: Numerics = EXACT) -> torch.Tensor:
    """v = K m on (..., H, W): dense up to ``DENSE_MAX_SIDE``, else FFT."""
    h, w = m.shape[-2:]
    if max(h, w) <= DENSE_MAX_SIDE:
        return _sharp_dense(m, alpha, gamma, power, num)
    return _sharp_fft(m, alpha, gamma, power, num)


def _sharp_dense(m: torch.Tensor, alpha: float, gamma: float, power: int,
                 num: Numerics = EXACT) -> torch.Tensor:
    """v = K m as matmuls, any side: Ty^T [(Ty m Tx^T) W] Tx."""
    h, w = m.shape[-2:]
    ty, tx, wgt = (_on(m, a) for a in _metric_operands(h, w, float(alpha),
                                                        float(gamma),
                                                        int(power)))
    ty, tx, wgt = num(ty), num(tx), num(wgt)
    xh = num(num(ty @ m.float()) @ tx.T)
    return num(num(ty.T @ num(xh * wgt)) @ tx)


@functools.lru_cache(maxsize=None)
def _metric_rfft_weights(h: int, w: int, alpha: float, gamma: float,
                         power: int) -> np.ndarray:
    """1 / spectrum of K on the rfft2 grid (H, W // 2 + 1): the same
    5-point Laplacian eigenvalues as ``_metric_operands``."""
    fy, fx = np.arange(h), np.arange(w // 2 + 1)
    lam = (2.0 - 2.0 * np.cos(2 * np.pi * fy / h))[:, None] \
        + (2.0 - 2.0 * np.cos(2 * np.pi * fx / w))[None, :]
    return (1.0 / (gamma + alpha * lam) ** power).astype(np.float32)


def _num_c(num: Numerics, z: torch.Tensor) -> torch.Tensor:
    """``num`` on the real and imaginary parts of a complex tensor."""
    if not num.lowp:
        return z
    return torch.view_as_complex(num(torch.view_as_real(z)).contiguous())


def _sharp_fft(m: torch.Tensor, alpha: float, gamma: float, power: int,
               num: Numerics = EXACT) -> torch.Tensor:
    """v = K m as irfft2(rfft2(m) / spectrum)."""
    h, w = m.shape[-2:]
    wgt = num(_on(m, _metric_rfft_weights(h, w, float(alpha), float(gamma),
                                          int(power))))
    xh = _num_c(num, torch.fft.rfft2(m.float()))
    return num(torch.fft.irfft2(_num_c(num, xh * wgt), s=(h, w)))


@functools.lru_cache(maxsize=None)
def band_resize_matrix(n1: int, n2: int) -> np.ndarray:
    """(n2, n1) matrix of the 1-D symmetric band-limited resize: shared
    frequencies copy, the Nyquist of the smaller even grid folds or splits
    with weight 1/2 a sign."""
    f = np.fft.fft(np.eye(n1), axis=0)
    g = np.zeros((n2, n1), complex)
    k = min(n1, n2) // 2
    g[:k] = f[:k]
    if k > 1:
        g[n2 - k + 1:] = f[n1 - k + 1:]
    if min(n1, n2) == 1:
        g[0] = f[0]
    elif min(n1, n2) % 2:
        g[k] = f[k]
        g[n2 - k] = f[n1 - k]
    elif n2 < n1:
        g[k] = 0.5 * (f[k] + f[n1 - k])
    elif n2 > n1:
        g[k] = 0.5 * f[k]
        g[n2 - k] = 0.5 * f[k]
    else:
        g[k] = f[k]
    return (np.fft.ifft(g, axis=0).real * (n2 / n1)).astype(np.float32)


def spectral_resize(x: torch.Tensor, out_hw, num: Numerics = EXACT
                    ) -> torch.Tensor:
    """Band-limited resampling of (..., H, W) to ``out_hw``: dense up to
    ``DENSE_MAX_SIDE`` on every side, else FFT."""
    h, w = x.shape[-2:]
    if max(h, w, *out_hw) <= DENSE_MAX_SIDE:
        return _resize_dense(x, out_hw, num)
    return _resize_fft(x, out_hw, num)


def _resize_dense(x: torch.Tensor, out_hw, num: Numerics = EXACT
                  ) -> torch.Tensor:
    """The resize as matmuls, any side: Ry x Rx^T."""
    h, w = x.shape[-2:]
    h2, w2 = out_hw
    ry = num(_on(x, band_resize_matrix(h, h2)))
    rx = num(_on(x, band_resize_matrix(w, w2)))
    return num(num(ry @ x.float()) @ rx.T)


def _band_axis(x: torch.Tensor, n2: int, dim: int) -> torch.Tensor:
    """``band_resize_matrix``'s rule along ``dim`` in the Fourier domain:
    the first min(n1, n2) // 2 = k frequencies copy (their negative
    partners follow by symmetry); at k an odd smaller grid copies too, an
    even smaller output keeps the real part (the two Nyquist halves
    folded), an even smaller input splits its real Nyquist in halves."""
    n1 = x.shape[dim]
    if n1 == n2:
        return x
    f = torch.fft.rfft(x, dim=dim)
    k = min(n1, n2) // 2
    if min(n1, n2) % 2:
        g = f.narrow(dim, 0, k + 1)
    else:
        edge = f.narrow(dim, k, 1).real * (1.0 if n2 < n1 else 0.5)
        g = torch.cat([f.narrow(dim, 0, k),
                       torch.complex(edge, torch.zeros_like(edge))], dim=dim)
    pad = list(g.shape)
    pad[dim] = n2 // 2 + 1 - g.shape[dim]
    g = torch.cat([g, g.new_zeros(pad)], dim=dim)
    return torch.fft.irfft(g, n=n2, dim=dim) * (n2 / n1)


def _resize_fft(x: torch.Tensor, out_hw, num: Numerics = EXACT
                ) -> torch.Tensor:
    """The resize along H, then along W, each through rfft / irfft."""
    h2, w2 = out_hw
    y = num(_band_axis(x.float(), int(h2), -2))
    return num(_band_axis(y, int(w2), -1))


# ---- the clamped bilinear warp --------------------------------------------- #
def warp(field: torch.Tensor, disp: torch.Tensor, radius: int,
         num: Numerics = EXACT) -> torch.Tensor:
    """field (N, C, H, W) sampled at (i, j) + disp (N, 2, H, W), the
    displacement clamped to +-(radius - 1) px and the coordinate clipped to
    the frame; the far tap is min(near + 1, side - 1)."""
    n, c, h, w = field.shape
    r = float(radius - 1)
    ii = torch.arange(h, device=disp.device, dtype=disp.dtype).view(1, h, 1)
    jj = torch.arange(w, device=disp.device, dtype=disp.dtype).view(1, 1, w)
    cy = (ii + disp[:, 0].clamp(-r, r)).clamp(0.0, h - 1.0)
    cx = (jj + disp[:, 1].clamp(-r, r)).clamp(0.0, w - 1.0)
    y0, x0 = torch.floor(cy), torch.floor(cx)
    fy, fx = (cy - y0).unsqueeze(1), (cx - x0).unsqueeze(1)
    y0i, x0i = y0.long(), x0.long()
    y1i, x1i = (y0i + 1).clamp(max=h - 1), (x0i + 1).clamp(max=w - 1)
    flat = field.reshape(n, c, h * w)

    def tap(yi, xi):
        idx = (yi * w + xi).reshape(n, 1, h * w).expand(n, c, h * w)
        return torch.gather(flat, 2, idx).reshape(n, c, h, w)

    v00, v01, v10, v11 = tap(y0i, x0i), tap(y0i, x1i), tap(y1i, x0i), \
        tap(y1i, x1i)
    return num((1.0 - fx) * ((1.0 - fy) * v00 + fy * v10)
               + fx * ((1.0 - fy) * v01 + fy * v11))


# ---- EPDiff shooting --------------------------------------------------------- #
def grad_hw(f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central d/dy, d/dx of (..., H, W), one-sided at the borders."""
    fy = torch.cat([f[..., 1:2, :] - f[..., 0:1, :],
                    (f[..., 2:, :] - f[..., :-2, :]) * 0.5,
                    f[..., -1:, :] - f[..., -2:-1, :]], dim=-2)
    fx = torch.cat([f[..., :, 1:2] - f[..., :, 0:1],
                    (f[..., :, 2:] - f[..., :, :-2]) * 0.5,
                    f[..., :, -1:] - f[..., :, -2:-1]], dim=-1)
    return fy, fx


def epdiff_step(v, m, u, dt: float, radius: int, num: Numerics = EXACT):
    """One Euler step: m' = m - dt ad*_v m with
    ad*_v m = (Dv)^T m + (Dm) v + m div v, and the inverse map's
    displacement u' = b + warp(u, b), b = -dt v, clamped at radius - 1."""
    vy, vx, my, mx = v[:, 0], v[:, 1], m[:, 0], m[:, 1]
    dvy_dy, dvy_dx = grad_hw(vy)
    dvx_dy, dvx_dx = grad_hw(vx)
    dmy_dy, dmy_dx = grad_hw(my)
    dmx_dy, dmx_dx = grad_hw(mx)
    div = dvy_dy + dvx_dx
    a_y = dvy_dy * my + dvx_dy * mx + dmy_dy * vy + dmy_dx * vx + my * div
    a_x = dvy_dx * my + dvx_dx * mx + dmx_dy * vy + dmx_dx * vx + mx * div
    m_new = num(torch.stack([my - dt * a_y, mx - dt * a_x], dim=1))
    b = -dt * v
    return m_new, num(b + warp(u, b, radius, num))


def shoot(m0: torch.Tensor, alpha: float, gamma: float, power: int,
          n_steps: int, radius: int, downsample: int,
          num: Numerics = EXACT):
    """(u_inv, v0, u_low): the inverse map's displacement after ``n_steps``
    Euler steps from m0 (B, 2, H, W), the initial velocity K m0, and the
    displacement on the integration grid in full-pixel units (None at full
    resolution). With ``downsample`` ds the integration runs on the
    (H/ds, W/ds) grid with alpha / ds^2 and the displacement is resized
    back."""
    h, w = m0.shape[-2:]
    ds = int(downsample)
    if ds > 1 and (h % ds or w % ds or min(h, w) < 4 * ds):
        ds = 1
    v0 = sharp(m0, alpha, gamma, power, num)
    if ds > 1:
        m_low = num(spectral_resize(m0, (h // ds, w // ds), num) / ds)
        u_low, _, _ = shoot(m_low, alpha / (ds * ds), gamma, power, n_steps,
                            radius, 1, num)
        return num(spectral_resize(u_low, (h, w), num) * ds), v0, \
            num(u_low * ds)
    dt = 1.0 / n_steps
    m, u = m0, torch.zeros_like(m0)
    for t in range(n_steps):
        v = v0 if t == 0 else sharp(m, alpha, gamma, power, num)
        m, u = epdiff_step(v, m, u, dt, min(2, radius), num)
    return u, v0, None


# ---- strain smoothing ------------------------------------------------------ #
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ERFINV_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                        -4.39150654e-06, 0.00021858087, -0.00125372503,
                        -0.00417768164, 0.246640727, 1.50140941], np.float32)
_ERFINV_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322,
                        -0.00367342844, 0.00573950773, -0.0076224613,
                        0.00943887047, 1.00167406, 2.83297682], np.float32)


def _threefry2x32(x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32, 20 rounds, key (0, 0), wrapping uint32 arithmetic."""
    ks = (np.uint32(0), np.uint32(0), np.uint32(0x1BD11BDA))
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


@functools.lru_cache(maxsize=None)
def start_matrix(t: int, rank: int) -> np.ndarray:
    """The smoothing's fixed (t, rank) start matrix: standard normals from
    threefry counters under key 0, mapped through XLA's float32 erfinv."""
    idx = np.arange(t * rank, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        b0, b1 = _threefry2x32(hi, lo)
    mant = ((b0 ^ b1) >> np.uint32(9)) | np.uint32(0x3F800000)
    unit = mant.view(np.float32) - np.float32(1)
    low = np.nextafter(np.float32(-1), np.float32(0))
    x = np.maximum(low, unit * (np.float32(1) - low) + low)
    w = -np.log1p(-x * x)
    lt = w < np.float32(5)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3))
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = np.where(lt, c_lt, c_ge).astype(np.float64)
        p = (c + p.astype(np.float64) * w.astype(np.float64)).astype(
            np.float32)
    return (np.float32(np.sqrt(2)) * (p * x)).reshape(t, rank)


def _orth(y: torch.Tensor, num: Numerics, eps: float = 1e-6) -> torch.Tensor:
    """Q = y L^-T with L L^T = y^T y + (eps * mean diagonal + 1e-10) I."""
    gram = y.transpose(-1, -2) @ y
    r = gram.shape[-1]
    eye = torch.eye(r, dtype=y.dtype, device=y.device)
    scale = gram.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None] / r
    chol = torch.linalg.cholesky(gram + (eps * scale + 1e-10) * eye)
    inv_l = torch.linalg.solve_triangular(chol, eye.expand_as(chol),
                                          upper=False)
    return num(y @ num(inv_l).transpose(-1, -2))


def subspace_smooth(x: torch.Tensor, rank: int, n_iters: int,
                    num: Numerics = EXACT) -> torch.Tensor:
    """Rank-``rank`` projection of x (..., S, T) by subspace iteration from
    the fixed start matrix."""
    omega = num(torch.as_tensor(start_matrix(x.shape[-1], rank),
                                device=x.device)).to(x.dtype)
    q = _orth(num(x @ omega), num)
    for _ in range(n_iters):
        qz = _orth(num(x.transpose(-1, -2) @ q), num)
        q = _orth(num(x @ qz), num)
    return num(q @ num(q.transpose(-1, -2) @ x))


def mask_sum(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over each row (axis 0), then the mask-weighted mean of rows."""
    per = x.reshape(x.shape[0], -1).mean(dim=1)
    if mask is None:
        return per.mean()
    w = mask.to(per.dtype)
    return (per * w).sum() / w.sum().clamp_min(1.0)
