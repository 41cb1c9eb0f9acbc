"""Offline and training-time figures: 3D activation maps, the TOS surface,
the strain, registration and sector figures (matplotlib, imported inside
the plotting functions only)."""
