"""reg: standalone pairwise diffeomorphic registration.

Counterpart of ``cardiax/train/schemes/reg.py:RegScheme``: one
registration model over (source_img, target_img) pairs. Its energy comes
through the config's losses; a config that declares none gets the LDDMM
energy ``0.5 * MSE(tar, deformed) / sigma^2 + reg_weight * (v . m).sum() /
numel`` as its default, with ``sigma`` and ``regularization_weight`` from
the training config. ``performance`` adds the mean squared reconstruction
error to the TOS metrics.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from cardiax_torch.train.engine import Scheme


class RegScheme(Scheme):
    name = "reg"

    def __init__(self, trainer_config, full_config):
        super().__init__(trainer_config, full_config)
        if not full_config.get("losses"):
            # the reference trainer hardcodes the LDDMM energy; it enters as
            # a default config entry, which the engine's LossCalculator reads
            full_config["losses"] = {
                "registration_reconstruction": {
                    "criterion": "registration_reconstruction",
                    "prediction": "various", "target": "registration_target",
                    "weight": 1.0,
                    "sigma": float(trainer_config.get("sigma", 0.03)),
                    "regularization_weight": float(
                        trainer_config.get("regularization_weight", 0.1)),
                    "enable": True,
                }
            }
        self.model_key = None   # the first model's name, at the first call

    def _key(self, modules: Dict[str, Any]) -> str:
        if self.model_key is None:
            self.model_key = next(iter(modules))
        return self.model_key

    def example_model_args(self, modules: Dict[str, Any],
                           arrays: Dict[str, torch.Tensor]
                           ) -> Dict[str, tuple]:
        return {self._key(modules): (arrays["source_img"],
                                     arrays["target_img"])}

    def forward(self, modules: Dict[str, Any], arrays: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        src, tar = arrays["source_img"], arrays["target_img"]
        preds = modules[self._key(modules)](src, tar)
        # X/Y components for DENSE displacement supervision
        preds["displacement_field_X"] = preds["displacement"][:, 1:2]
        preds["displacement_field_Y"] = preds["displacement"][:, 0:1]
        targets = {"registration_target": tar, "source_img": src}
        for k in ("displacement_field_X", "displacement_field_Y",
                  "sample_mask", "TOS"):
            if k in arrays:
                targets[k] = arrays[k]
        return preds, targets

    def performance(self, preds: List[Dict[str, Any]], dataset_name: str
                    ) -> Dict[str, float]:
        """The TOS metrics and the mean squared reconstruction error."""
        perf = super().performance(preds, dataset_name)
        errs = [float(np.mean((np.asarray(p["deformed_source_pred"])
                               - np.asarray(p["target_img"])) ** 2))
                for p in preds
                if "deformed_source_pred" in p and "target_img" in p]
        if errs:
            perf[f"final-{dataset_name}/reconstruction_mse"] = \
                float(np.mean(errs))
        return perf
