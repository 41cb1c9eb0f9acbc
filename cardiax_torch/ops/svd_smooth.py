"""Rank-k smoothing of strain matrices by subspace iteration.

Counterpart of ``cardiax/ops/svd_smooth.py`` (``svd_denoise``,
``_safe_orth``, ``subspace_denoise``): an orthonormal basis Q of the
top-``rank`` column space of x (..., S, T) by power iteration from a fixed
start matrix, then Q Q^T x. Orthogonalisation is a ridge Cholesky whiten
(differentiable at any rank).

The JAX start matrix is ``jax.random.normal(PRNGKey(0), (T, rank), f32)``.
``start_matrix`` regenerates it on the host in numpy for any (T, rank):
threefry-2x32 of each element's flat index under key (0, 0) (JAX's
partitionable mode), the bits mapped to [-1, 1) through the mantissa, then
``sqrt(2) * erfinv`` with XLA's f32 polynomial for ``erfinv``
(``tests/test_torch_ops.py`` holds it to JAX: bit-equal at (40, 5) and
(16, 5), within 2 ulp elsewhere). ``svd_denoise`` is the exact truncated
SVD, for numpy arrays and tensors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from cardiax_torch.ops.fluid_metric import _const

_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# XLA's f32 erfinv (Giles' single-precision polynomial), for w = -log1p(-x^2)
# below 5 and at or above it
_ERFINV_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                        -4.39150654e-06, 0.00021858087, -0.00125372503,
                        -0.00417768164, 0.246640727, 1.50140941], np.float32)
_ERFINV_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322,
                        -0.00367342844, 0.00573950773, -0.0076224613,
                        0.00943887047, 1.00167406, 2.83297682], np.float32)


def _threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 (20 rounds) of the counters (x0, x1) under key (k0, k1),
    in uint32 arithmetic that wraps."""
    ks = (np.uint32(k0), np.uint32(k1),
          np.uint32(k0) ^ np.uint32(k1) ^ np.uint32(0x1BD11BDA))
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's f32 ``erf_inv``; its Horner steps are fused multiply-adds,
    done here in float64 and rounded once to f32."""
    w = -np.log1p(-x * x)
    lt = w < np.float32(5)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3))
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = np.where(lt, c_lt, c_ge).astype(np.float64)
        p = (c + p.astype(np.float64) * w.astype(np.float64)
             ).astype(np.float32)
    return p * x


def jax_normal_f32(t: int, rank: int) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(0), (t, rank), float32)``."""
    idx = np.arange(t * rank, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        b0, b1 = _threefry2x32(0, 0, hi, lo)
    mantissa = ((b0 ^ b1) >> np.uint32(9)) | np.uint32(0x3F800000)
    unit = mantissa.view(np.float32) - np.float32(1)            # [0, 1)
    low = np.nextafter(np.float32(-1), np.float32(0))
    u = np.maximum(low, unit * (np.float32(1) - low) + low)     # [-1, 1)
    return (np.float32(np.sqrt(2)) * _erfinv_f32(u)).reshape(t, rank)


def start_matrix(t: int, rank: int, device=None) -> torch.Tensor:
    """The (t, rank) start matrix on ``device`` (cached: one host copy)."""
    return _const(torch.device(device or "cpu"), ("start", t, rank),
                  lambda: jax_normal_f32(t, rank))


def svd_denoise(x, rank: int = 3):
    """Exact rank-``rank`` reconstruction of (..., S, T) matrices: numpy in,
    numpy out; a tensor goes through ``torch.linalg.svd``."""
    if isinstance(x, np.ndarray):
        u, s, vt = np.linalg.svd(x, full_matrices=False)
        s = s.copy()
        s[..., rank:] = 0.0
        return (u * s[..., None, :]) @ vt
    u, s, vt = torch.linalg.svd(x, full_matrices=False)
    s = torch.cat([s[..., :rank], torch.zeros_like(s[..., rank:])], dim=-1)
    return (u * s[..., None, :]) @ vt


def _safe_orth(y: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Near-orthonormal basis of the columns of y (..., n, r):
    Q = y L^{-T} with L L^T = y^T y + eps*scale*I."""
    gram = y.transpose(-1, -2) @ y                              # (..., r, r)
    r = gram.shape[-1]
    eye = torch.eye(r, dtype=y.dtype, device=y.device)
    scale = gram.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None] / r
    # cholesky_ex: the same factor as cholesky, without its error check,
    # which reads ``info`` back to the host (a sync, refused inside a CUDA
    # graph capture); the shift keeps the Gram matrix positive definite
    chol, _ = torch.linalg.cholesky_ex(gram + (eps * scale + 1e-10) * eye)
    inv_l = torch.linalg.solve_triangular(chol, eye.expand_as(chol),
                                          upper=False)
    return y @ inv_l.transpose(-1, -2)


def subspace_denoise(x: torch.Tensor, rank: int = 5,
                     n_iters: int = 4) -> torch.Tensor:
    """Low-rank projection of x (..., S, T) by subspace iteration."""
    omega = start_matrix(x.shape[-1], rank, x.device).to(x.dtype)
    q = _safe_orth(x @ omega)                                   # (..., S, r)
    for _ in range(n_iters):
        qz = _safe_orth(x.transpose(-1, -2) @ q)                # (..., T, r)
        q = _safe_orth(x @ qz)
    return q @ (q.transpose(-1, -2) @ x)
