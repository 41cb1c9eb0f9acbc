"""Training-time figures (matplotlib, imported inside each function)."""
