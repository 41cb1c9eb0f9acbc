"""strainmat_pred: displacement video -> strain matrix regression.

Counterpart of ``cardiax/train/schemes/strainmat_pred.py``: the model
(``masks_to_strain_mat``, else the first configured one) maps the
(B, 2, H, W, T) displacement video to ``{'strainmat': (B, 126, T)}``; a
config without losses gets MSE against the GT strain matrix. ``performance``
adds the mean squared strain-matrix error to the TOS metrics.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from cardiax_torch.train.engine import Scheme


class StrainMatPredScheme(Scheme):
    name = "strainmat_pred"
    model_keys = ("masks_to_strain_mat",)

    def __init__(self, trainer_config, full_config):
        super().__init__(trainer_config, full_config)
        if not full_config.get("losses"):
            full_config["losses"] = {
                "strainmat_MSE": {"criterion": "MSELoss",
                                  "prediction": "strainmat",
                                  "target": "strainmat", "weight": 1.0,
                                  "enable": True}
            }
        self.model_key = None

    def _key(self, modules: Dict[str, Any]) -> str:
        if self.model_key is None:
            self.model_key = "masks_to_strain_mat" \
                if "masks_to_strain_mat" in modules else next(iter(modules))
        return self.model_key

    def example_model_args(self, modules: Dict[str, Any],
                           arrays: Dict[str, torch.Tensor]
                           ) -> Dict[str, tuple]:
        return {self._key(modules): (arrays["displacement_field"],)}

    def forward(self, modules: Dict[str, Any], arrays: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        preds = modules[self._key(modules)](arrays["displacement_field"])
        targets = {"strainmat": arrays["strain_mat"]}
        for k in ("sample_mask", "TOS"):
            if k in arrays:
                targets[k] = arrays[k]
        return preds, targets

    def performance(self, preds: List[Dict[str, Any]], dataset_name: str
                    ) -> Dict[str, float]:
        """The TOS metrics and the mean squared strain-matrix error."""
        perf = super().performance(preds, dataset_name)
        errs = [float(np.mean((np.asarray(p["strainmat_pred"])
                               - np.asarray(p["strain_mat"])) ** 2))
                for p in preds if "strainmat_pred" in p and "strain_mat" in p]
        if errs:
            perf[f"final-{dataset_name}/strainmat_mse"] = float(np.mean(errs))
        return perf
