"""strainmat_LMA: displacement -> strain net -> LMA net, trained jointly.

Counterpart of ``cardiax/train/schemes/strainmat_lma.py``: the ``strain``
model maps the displacement video to ``{'strainmat': (B, S, T)}``, the
``LMA`` model reads it as (B, 1, S, T); each has its optimizer. A config
without losses gets strain-matrix MSE (weight 1) and TOS MSE (0.005).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from cardiax_torch.train.engine import Scheme


class StrainMatLMAScheme(Scheme):
    name = "strainmat_LMA"
    model_keys = ("strain", "LMA")

    def __init__(self, trainer_config, full_config):
        super().__init__(trainer_config, full_config)
        if not full_config.get("losses"):
            full_config["losses"] = {
                "strainmat_MSE": {"criterion": "MSELoss",
                                  "prediction": "strainmat",
                                  "target": "strainmat", "weight": 1.0,
                                  "enable": True},
                "TOS_regression": {"criterion": "MSELoss",
                                   "prediction": "TOS", "target": "TOS",
                                   "weight": 0.005, "enable": True},
            }

    def example_model_args(self, modules: Dict[str, Any],
                           arrays: Dict[str, torch.Tensor]
                           ) -> Dict[str, tuple]:
        """The displacement for ``strain``; for ``LMA`` zeros of the strain
        matrix's shape (B, 1, S, T), which one forward of the strain net
        gives (JAX takes it from an abstract trace)."""
        disp = arrays["displacement_field"]
        with torch.no_grad():
            sm = modules["strain"](disp)["strainmat"]
        return {"strain": (disp,), "LMA": (torch.zeros_like(sm)[:, None],)}

    def forward(self, modules: Dict[str, Any], arrays: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        strainmat = modules["strain"](arrays["displacement_field"])["strainmat"]
        preds = {"strainmat": strainmat,
                 **modules["LMA"](strainmat[:, None])}
        targets = {"strainmat": arrays["strain_mat"]}
        for k in ("TOS", "sector_LMA_labels", "slice_LMA_label",
                  "sample_mask"):
            if k in arrays:
                targets[k] = arrays[k]
        return preds, targets
