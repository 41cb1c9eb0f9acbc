"""Launch counts of the port's kernels, by kernel name.

Each kernel wrapper (``warp_kernels``, ``epdiff_kernels``) adds one to its
kernel's count where it launches the kernel, and nowhere else. A CUDA
graph's replay runs no Python, so ``train.graphs`` takes a snapshot of the
counts around a capture and adds the captured launches back at each replay:
the counts stay what the card ran.
"""

from __future__ import annotations

from typing import Dict

KERNELS = ("mc_warp_fwd", "mc_warp_disp_bwd", "mc_warp_fused_bwd",
           "epdiff_step_fwd", "epdiff_step_bwd", "epdiff_step_solve_fwd",
           "epdiff_step_solve_bwd")

launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)


def count(name: str) -> None:
    """One launch of kernel ``name``."""
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
