"""Colormaps and value -> RGB mapping for activation maps.

Copy of ``cardiax/plot/colors.py``. The two custom maps, ``blue_red`` and
``green_yellow_red``, are built here in numpy as matplotlib's
``LinearSegmentedColormap.from_list`` builds them (a 256-entry lookup
table, the same arithmetic, so the same colors bit for bit): the activation
map needs no matplotlib, which the card's machine lacks. Any other name is
matplotlib's, imported inside the call.
"""

from __future__ import annotations

import numpy as np

_CUSTOM = {"blue_red": ((0, 0, 1), (1, 0, 0)),
           "green_yellow_red": ((0, 0.8, 0), (1, 1, 0), (1, 0, 0))}


def _lookup_table(n: int, vals: np.ndarray, y: np.ndarray) -> np.ndarray:
    """matplotlib's ``_create_lookup_table`` for a continuous segment map
    (y0 == y1) with gamma 1."""
    x = vals * (n - 1)
    xind = (n - 1) * np.linspace(0, 1, n) ** 1.0
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y[0]], distance * (y[ind] - y[ind - 1]) + y[ind - 1],
                          [y[-1]]])
    return np.clip(lut, 0.0, 1.0)


class SegmentedColormap:
    """A colormap of colors evenly spaced on [0, 1], called like
    matplotlib's: floats in [0, 1] -> RGBA (..., 4); NaN -> (0, 0, 0, 0)."""

    def __init__(self, name: str, colors, n: int = 256):
        self.name, self.N = name, n
        rgb = np.asarray(colors, float)
        vals = np.linspace(0, 1, len(rgb))
        lut = np.ones((n + 3, 4), float)
        for c in range(3):
            lut[:-3, c] = _lookup_table(n, vals, rgb[:, c])
        lut[n] = lut[0]                  # under
        lut[n + 1] = lut[n - 1]          # over
        lut[n + 2] = 0.0                 # bad
        self._lut = lut

    def __call__(self, x) -> np.ndarray:
        xa = np.array(x, dtype=float, copy=True)
        xa *= self.N
        xa[xa == self.N] = self.N - 1
        under, over, bad = xa < 0, xa >= self.N, np.isnan(xa)
        with np.errstate(invalid="ignore"):
            xa = xa.astype(int)
        xa[under] = self.N
        xa[over] = self.N + 1
        xa[bad] = self.N + 2
        return self._lut.take(xa, axis=0, mode="clip")


def get_cmap(name: str = "blue_red"):
    """Custom colormaps: 'blue_red' and 'green_yellow_red'; any other name
    is matplotlib's."""
    if name in _CUSTOM:
        return SegmentedColormap(name, _CUSTOM[name])
    import matplotlib.pyplot as plt
    return plt.get_cmap(name)


def map_values_to_rgb(values: np.ndarray, vmin: float | None = None,
                      vmax: float | None = None,
                      cmap_name: str = "green_yellow_red") -> np.ndarray:
    """Normalize values and map through the cmap -> (N, 3) RGB."""
    values = np.asarray(values, float)
    vmin = float(values.min()) if vmin is None else vmin
    vmax = float(values.max()) if vmax is None else vmax
    denom = max(vmax - vmin, 1e-9)
    normed = np.clip((values - vmin) / denom, 0.0, 1.0)
    cmap = get_cmap(cmap_name)
    return np.asarray(cmap(normed))[..., :3]
