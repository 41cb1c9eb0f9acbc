"""LMA: strain matrix (or displacement video) -> TOS / LMA labels.

Counterpart of ``cardiax/train/schemes/lma.py:LMAScheme``. The
``LMA_modality`` ``strain_mat`` feeds the (B, 1, 126, T) strain matrix to
the ``LMA`` model; ``displacement_field`` concatenates the X and Y fields
on axis 1 into (B, 2, H, W, T). The targets are the batch's TOS, LMA
labels, strain matrix and ``sample_mask``, where present; the losses come
from the config.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from cardiax_torch.train.engine import Scheme

_TARGET_KEYS = ("TOS", "sector_LMA_labels", "slice_LMA_label", "strain_mat",
                "sample_mask")


class LMAScheme(Scheme):
    name = "LMA"
    model_keys = ("LMA",)

    def __init__(self, trainer_config, full_config):
        super().__init__(trainer_config, full_config)
        self.modality = trainer_config.get("LMA_modality", "strain_mat")
        self.task = trainer_config.get("LMA_task", "TOS_regression")

    def _input(self, arrays: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.modality == "strain_mat":
            return arrays["strain_mat"]
        return torch.cat([arrays["displacement_field_X"],
                          arrays["displacement_field_Y"]], dim=1)

    def example_model_args(self, modules: Dict[str, Any],
                           arrays: Dict[str, torch.Tensor]
                           ) -> Dict[str, tuple]:
        return {"LMA": (self._input(arrays),)}

    def forward(self, modules: Dict[str, Any], arrays: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        preds = modules["LMA"](self._input(arrays))
        targets = {k: arrays[k] for k in _TARGET_KEYS if k in arrays}
        return preds, targets
