"""Training schemes of the port (only the flagship one so far)."""
