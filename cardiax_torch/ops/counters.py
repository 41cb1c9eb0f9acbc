"""Launch counts of the port's kernels, and call counts of the FFT
branches of the fluid metric and the resize, by name.

Each kernel wrapper (``warp_kernels``, ``epdiff_kernels``) adds one to its
kernel's count where it launches the kernel, and nowhere else. Each FFT
branch of ``ops.fluid_metric`` (``sharp``, ``flat`` and
``spectral_resize`` on sides over ``_MM_MAX_SIDE``) adds one to its count
(``FFT_BRANCHES``) for each forward call, which is one ``rfft2`` and one
``irfft2``; the transforms of autograd's backward run in C++ and are not
counted. A CUDA graph's replay runs no Python, so ``train.graphs`` takes a
snapshot of the counts around a capture and adds the captured launches and
calls back at each replay: the counts stay what the card ran.
"""

from __future__ import annotations

from typing import Dict

KERNELS = ("mc_warp_fwd", "mc_warp_disp_bwd", "mc_warp_fused_bwd",
           "epdiff_step_fwd", "epdiff_step_bwd", "epdiff_step_solve_fwd",
           "epdiff_step_solve_bwd")

FFT_BRANCHES = ("fft_sharp", "fft_flat", "fft_resize")

launches: Dict[str, int] = dict.fromkeys(KERNELS + FFT_BRANCHES, 0)


def count(name: str) -> None:
    """One launch of kernel ``name``, or one call of FFT branch ``name``."""
    launches[name] += 1


def snapshot() -> Dict[str, int]:
    return dict(launches)


def add(delta: Dict[str, int], times: int = 1) -> None:
    """``delta`` (a difference of two snapshots) ``times`` times."""
    for name, n in delta.items():
        launches[name] += n * times


def reset() -> None:
    for name in launches:
        launches[name] = 0
