"""Geometric and spectral operators of the port (counterparts in ``cardiax/ops``)."""
