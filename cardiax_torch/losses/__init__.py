"""Losses and evaluation metrics of the port (counterparts in ``cardiax/losses``)."""
