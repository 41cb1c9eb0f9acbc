"""Losses and evaluation metrics of the port (counterparts in ``cardiax/losses``)."""

from cardiax_torch.losses.calculator import LossCalculator, get_loss_function
from cardiax_torch.losses.metrics import (get_average_performance_dict,
                                          tos_sector_error)
from cardiax_torch.losses.registration import (
    gradient_magnitude_loss,
    lddmm_energy,
    registration_reconstruction_loss,
)

__all__ = [
    "LossCalculator",
    "get_loss_function",
    "lddmm_energy",
    "registration_reconstruction_loss",
    "gradient_magnitude_loss",
    "get_average_performance_dict",
    "tos_sector_error",
]
