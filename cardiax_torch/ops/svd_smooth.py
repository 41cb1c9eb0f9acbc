"""Rank-k smoothing of strain matrices by subspace iteration.

Counterpart of ``cardiax/ops/svd_smooth.py`` (``_safe_orth``,
``subspace_denoise``): an orthonormal basis Q of the top-``rank`` column
space of x (..., S, T) by power iteration from a fixed start matrix, then
Q Q^T x. Orthogonalisation is a ridge Cholesky whiten (differentiable at any
rank).

The JAX start matrix is ``jax.random.normal(PRNGKey(0), (T, rank), f32)``,
which PyTorch cannot regenerate; the flagship's (T, rank) = (40, 5) draw is
stored below as a literal. JAX's threefry bits are a function of each
element's flat index, so the (T, 5) draw for T <= 40 is its first T rows
(``tests/test_torch_ops.py`` holds both against JAX). Other shapes raise.
"""

from __future__ import annotations

import functools

import torch

# jax.random.normal(jax.random.PRNGKey(0), (40, 5), jnp.float32)
_START_40x5 = [
    [1.6226422, 2.0252647, -0.43359444, -0.07861735, 0.1760909],
    [-0.97208923, -0.49529874, 0.4943786, 0.6643493, -0.9501635],
    [2.1795304, -1.9551506, 0.35857072, 0.15779513, 1.2770847],
    [1.5104648, 0.970656, 0.59960806, 0.024700705, -1.9164772],
    [-1.8593491, 1.728144, 0.04719035, 0.814128, 0.13132767],
    [0.28284705, 1.2435943, 0.6902801, -0.80073744, -0.74099],
    [-1.5388287, 0.30269185, -0.020716045, 0.11328721, -0.2206547],
    [0.07052256, 0.8532958, -0.8217738, -0.014614211, -0.15046217],
    [-0.9001352, -0.7590727, 0.33309513, 0.80924904, 0.042692553],
    [-0.57767123, -0.41439894, -1.9412533, 1.3161184, 0.7542728],
    [0.16170931, -0.03483307, -1.3306409, 0.39362028, 0.48259583],
    [0.80382955, -0.6337168, 1.038756, -0.74159133, -0.4299588],
    [-0.22510043, -0.51966715, -1.6692165, 0.67535436, 0.22738722],
    [-1.1800426, -0.97673357, 1.1969604, -0.84127563, 0.6598078],
    [1.0680159, 0.31542128, 0.43766403, 1.1718564, 0.9077099],
    [1.2226242, -0.54639524, 0.85630435, -0.007965775, 0.47343913],
    [-1.1090349, 2.6423514, 0.88957626, 0.9952015, 0.2551972],
    [0.124961376, 1.164173, 0.19296366, -0.19099544, -0.43659472],
    [-1.1461989, 0.19760251, 1.1686655, -0.8733985, 0.8818086],
    [-0.3441057, -0.14614972, -0.91352165, 1.370097, -0.7800775],
    [0.36481506, 0.9761402, -0.007172703, 0.21052206, 0.19035842],
    [0.38291267, -1.2656332, -1.4843545, -0.114543624, 1.1037136],
    [0.19846702, 0.21388935, -0.6605348, -0.72722006, 0.40443972],
    [0.18965738, -0.6031794, 0.9450588, 1.0838778, -2.0560737],
    [-0.71382153, 0.59286827, 1.0507762, -1.4646238, 0.66001135],
    [-0.30172178, 0.13313177, -0.33281323, 1.5700098, 0.5745121],
    [0.7234155, 0.6966845, -0.66423434, -1.9669566, -2.4162543],
    [0.27330154, 1.1603173, 0.2655127, 0.6909093, -0.2560643],
    [-2.0227401, -0.6231289, 0.2795317, -1.3503172, 0.10128845],
    [0.51268137, 0.2640195, -1.8291276, 1.4337775, 1.3188555],
    [-1.4953226, 0.93327594, 1.4092648, -0.16788375, -0.11862286],
    [-0.2428249, -0.96175927, -0.75636, 2.5728257, -1.0601792],
    [0.31232905, 0.3275118, 0.08283223, -1.0826886, -0.7722345],
    [-0.63460463, 1.2264103, -1.487015, -0.79286903, 0.5531185],
    [-1.1855397, 0.9769094, -0.43845034, -0.329756, 0.33254716],
    [-0.6527196, -1.2052122, -0.88630825, -2.1088374, -0.15503536],
    [-0.65793204, -0.663254, -0.03336205, -0.8959291, 0.0771168],
    [-0.909823, 1.276052, -0.40167663, -0.99992526, 0.017341979],
    [0.40454188, -1.0713243, 1.0366626, -0.6684805, -0.07793187],
    [1.2080221, 2.0031455, -0.07060029, 0.33603913, 2.354045],
]


@functools.lru_cache(maxsize=None)
def start_matrix(t: int, rank: int, device=None) -> torch.Tensor:
    """The (t, rank) start matrix on ``device`` (cached: one host copy)."""
    if rank != 5 or not 1 <= t <= 40:
        raise NotImplementedError(
            f"subspace_denoise: only the (T, 5) start matrices, T <= 40, of "
            f"the JAX reference are stored; got ({t}, {rank})")
    with torch.inference_mode(False):     # a normal tensor, even if first
        return torch.tensor(_START_40x5[:t], dtype=torch.float32,
                            device=device)


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
