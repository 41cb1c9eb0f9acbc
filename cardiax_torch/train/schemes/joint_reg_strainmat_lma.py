"""joint_registration_strainmat_LMA: the flagship scheme (eval path).

Counterpart of ``cardiax/train/schemes/joint_reg_strainmat_lma.py``
(``_lagrangian_pairs``, ``forward``, ``performance``):

  batch cine_myo_mask (B,1,T,H,W)
    -> Lagrangian pairs: src/tar (B,1,T-1,H,W), frame 0 vs frames 1..T-1
    -> JointRegisterStrainMatNet.forward_volume -> strain_matrix, ...
    -> NetStrainMat2LMA(strain_matrix) -> TOS (B,S)
    -> losses: LDDMM energy + 1000*MSE(strain) + 0.005*MSE(TOS)

plus the LMA sector metrics (labels = TOS > LMA_threshold), AUC and the
threshold-sweep F1.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from cardiax_torch.losses.metrics import binary_auc, threshold_sweep_f1
from cardiax_torch.train.engine import Scheme


def _lagrangian_pairs(vol: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 1, T, H, W) -> src/tar (B, 1, T-1, H, W)."""
    b, c, t, h, w = vol.shape
    return vol[:, :, :1].expand(b, c, t - 1, h, w), vol[:, :, 1:]


class JointRegisterStrainmatLMAScheme(Scheme):
    name = "joint_registration_strainmat_LMA"
    model_keys = ("joint_register_strainmat", "LMA")

    def __init__(self, trainer_config, full_config):
        super().__init__(trainer_config, full_config)
        self.lma_threshold = float(self.trainer_config.get("LMA_threshold", 20))

    def example_model_args(self, modules: Dict[str, Any],
                           arrays: Dict[str, torch.Tensor]
                           ) -> Dict[str, tuple]:
        """(src, tar) of the Lagrangian pair split for the joint network;
        for ``LMA`` zeros of its strain matrix's shape (B, 1, S, Ts), read
        from the network's configuration, so no forward (and no kernel)
        runs (JAX takes the shape from an abstract trace)."""
        src, tar = _lagrangian_pairs(arrays["cine_myo_mask"])
        net = modules["joint_register_strainmat"]
        sm = src.new_zeros(src.shape[0], 1, net.n_sectors,
                           net.n_strain_matrix_frames)
        return {"joint_register_strainmat": (src, tar), "LMA": (sm,)}

    def forward(self, modules: Dict[str, Any], arrays: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        src, tar = _lagrangian_pairs(arrays["cine_myo_mask"])
        out = modules["joint_register_strainmat"].forward_volume(src, tar)
        lma_out = modules["LMA"](out["strain_matrix"])
        preds = {
            "strainmat": out["strain_matrix"],
            "strain_matrix": out["strain_matrix"],
            "deformed_source": out["deformed_source"],
            "velocity": out["velocity"],
            "momentum": out["momentum"],
            "displacement": out["displacement"],
            **lma_out,
        }
        targets = {"registration_target": tar,
                   "strainmat": arrays["strain_matrix"]}
        for k in ("TOS", "sample_mask"):
            if k in arrays:
                targets[k] = arrays[k]
        return preds, targets

    def performance(self, preds: List[Dict[str, Any]], dataset_name: str
                    ) -> Dict[str, float]:
        perf = super().performance(preds, dataset_name)
        tp = fp = fn = correct = total = 0
        scores, labels = [], []
        for p in preds:
            if "TOS_pred" not in p or "TOS" not in p:
                continue
            tos_pred = np.asarray(p["TOS_pred"])
            pred_lbl = tos_pred > self.lma_threshold
            true_lbl = np.asarray(p["TOS"]) > self.lma_threshold
            scores.append(tos_pred.reshape(-1))
            labels.append(true_lbl.reshape(-1))
            tp += int(np.sum(pred_lbl & true_lbl))
            fp += int(np.sum(pred_lbl & ~true_lbl))
            fn += int(np.sum(~pred_lbl & true_lbl))
            correct += int(np.sum(pred_lbl == true_lbl))
            total += pred_lbl.size
        if total:
            pre = f"final-{dataset_name}/"
            perf[pre + "LMA_accuracy"] = correct / total
            perf[pre + "LMA_precision"] = tp / (tp + fp) if tp + fp else 0.0
            perf[pre + "LMA_recall"] = tp / (tp + fn) if tp + fn else 0.0
            s = np.concatenate(scores)
            y = np.concatenate(labels)
            perf[pre + "LMA_auc"] = binary_auc(s, y)
            f1, thr = threshold_sweep_f1(s, y)
            perf[pre + "LMA_f1_best"] = f1
            perf[pre + "LMA_threshold_best"] = thr
        return perf
