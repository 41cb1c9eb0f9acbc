"""Metrics logging, predictions and trained models on disk, checkpoints,
and carrying weights between the JAX package's param trees and the port."""

from cardiax_torch.io.export import save_predictions, save_trained_models
from cardiax_torch.io.metrics import MetricsTracker

__all__ = ["MetricsTracker", "save_predictions", "save_trained_models"]
