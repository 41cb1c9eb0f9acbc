"""The strain matrix with its TOS curves: the periodic training figure.

Copy of ``cardiax/plot/strainmat.py:visualize_strainmat_with_TOS``.
matplotlib is imported inside the function, so importing this module needs
no plotting package.
"""

from __future__ import annotations

import numpy as np


def visualize_strainmat_with_TOS(strain_mat: np.ndarray, tos_gt=None, tos_pred=None,
                                 title: str = "", ax=None, frames_per_tos: float = 17.0):
    """pcolor of the (S, T) strain matrix with GT/pred TOS curves overlaid.

    TOS is in ms-like units, plotted as ``TOS/17 + 1`` frames.
    """
    import matplotlib.pyplot as plt
    if ax is None:
        _, ax = plt.subplots(figsize=(5, 4))
    sm = np.asarray(strain_mat)
    if sm.ndim == 3:
        sm = sm[0]
    pc = ax.pcolormesh(sm, cmap="RdBu_r", vmin=-0.25, vmax=0.25)
    sectors = np.arange(sm.shape[0]) + 0.5
    if tos_gt is not None:
        ax.plot(np.asarray(tos_gt) / frames_per_tos + 1, sectors, "k-", lw=2,
                label="TOS GT")
    if tos_pred is not None:
        ax.plot(np.asarray(tos_pred) / frames_per_tos + 1, sectors, "r--", lw=2,
                label="TOS pred")
    ax.set_xlabel("frame")
    ax.set_ylabel("sector")
    ax.set_title(title)
    if tos_gt is not None or tos_pred is not None:
        ax.legend(loc="upper right", fontsize=7)
    return ax.figure, pc
