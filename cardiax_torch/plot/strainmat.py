"""Training and evaluation figures: the strain matrix with its TOS curves
(the periodic training figure), registration grids and sector labels.

Copy of ``cardiax/plot/strainmat.py`` (``visualize_strainmat_with_TOS``,
``visualize_pred_registration``, ``visualize_pred_sector_classification``).
matplotlib is imported inside the functions, so importing this module needs
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


def visualize_pred_registration(source: np.ndarray, deformed: np.ndarray,
                                target: np.ndarray, n_cols: int = 8,
                                fig=None):
    """5-row grid: source / deformed / target / |deformed-target| /
    |source-target| (reference :884-936)."""
    import matplotlib.pyplot as plt
    src = np.asarray(source)[:, 0] if np.asarray(source).ndim == 4 else np.asarray(source)
    dfm = np.asarray(deformed)[:, 0] if np.asarray(deformed).ndim == 4 else np.asarray(deformed)
    tar = np.asarray(target)[:, 0] if np.asarray(target).ndim == 4 else np.asarray(target)
    n = min(n_cols, src.shape[0])
    rows = [src, dfm, tar, np.abs(dfm - tar), np.abs(src - tar)]
    labels = ["source", "deformed", "target", "|def-tar|", "|src-tar|"]
    if fig is None:
        fig, axes = plt.subplots(5, n, figsize=(1.2 * n, 6.5), squeeze=False)
    else:
        axes = fig.subplots(5, n, squeeze=False)
    for r, (row, lbl) in enumerate(zip(rows, labels)):
        for c in range(n):
            ax = axes[r][c]
            ax.imshow(row[c], cmap="gray")
            ax.set_xticks([]); ax.set_yticks([])
            if c == 0:
                ax.set_ylabel(lbl, fontsize=7)
    return fig


def visualize_pred_sector_classification(strain_mat: np.ndarray,
                                         labels_gt: np.ndarray,
                                         labels_pred_logits: np.ndarray, ax=None):
    """Strain matrix with GT/pred LMA sector bands (reference :997-1014)."""
    import matplotlib.pyplot as plt
    if ax is None:
        _, ax = plt.subplots(figsize=(5, 4))
    sm = np.asarray(strain_mat)
    if sm.ndim == 3:
        sm = sm[0]
    ax.pcolormesh(sm, cmap="RdBu_r", vmin=-0.25, vmax=0.25)
    pred = np.argmax(np.asarray(labels_pred_logits), axis=0) \
        if np.asarray(labels_pred_logits).ndim == 2 else np.asarray(labels_pred_logits)
    sectors = np.arange(sm.shape[0])
    gt = np.asarray(labels_gt).reshape(-1)
    t = sm.shape[1]
    ax.scatter(np.full(gt.sum(), t * 0.95), sectors[gt > 0], s=4, c="k",
               label="GT LMA")
    ax.scatter(np.full(int((pred > 0).sum()), t * 0.90), sectors[pred > 0], s=4,
               c="r", label="pred LMA")
    ax.legend(loc="lower right", fontsize=7)
    return ax.figure
