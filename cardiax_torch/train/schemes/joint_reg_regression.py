"""joint_registration_regression: pairwise registration, then LMA
regression on the slice's displacement video.

Counterpart of ``cardiax/train/schemes/joint_reg_regression.py``. Batches
are whole slices (``SliceBatcher``): arrays (S, P, ...) with ``pair_mask``
(S, P), P = min(``LMA_n_frames``, the longest slice). The S*P pairs go
through the registration model (``cine_registraion``, the reference's
spelling, else ``cine_registration``, ``registration`` or the first
non-LMA model): K2/K3 in its shooting, K1/K4 in its final warp on the card.
The displacement is multiplied by the union of the source and target masks
(``mask_displacement``) and by ``pair_mask``, regrouped per slice into the
video (S, 2, F, H, W), zero-padded or cut to F = ``LMA_n_frames``, and fed
to the ``LMA`` model. A config without losses gets the LDDMM energy over
the real pairs (``pair_sample_mask``) and TOS MSE (0.005).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from cardiax_torch.data.loader import SliceBatcher
from cardiax_torch.train.engine import Scheme


def _flatten_pairs(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


class JointRegistrationRegressionScheme(Scheme):
    name = "joint_registration_regression"
    model_keys = ("cine_registraion", "LMA")   # the reference's spelling

    def __init__(self, trainer_config, full_config):
        super().__init__(trainer_config, full_config)
        self.n_video_frames = int(trainer_config.get("LMA_n_frames", 48))
        self.mask_displacement = bool(trainer_config.get("mask_displacement",
                                                         False))
        self.reg_key = None
        if not full_config.get("losses"):
            full_config["losses"] = {
                "registration_reconstruction": {
                    "criterion": "registration_reconstruction",
                    "prediction": "various", "target": "registration_target",
                    "weight": 1.0, "sigma": 0.03,
                    "regularization_weight": 0.1,
                    "mask": "pair_sample_mask", "enable": True},
                "TOS_regression": {"criterion": "MSELoss",
                                   "prediction": "TOS", "target": "TOS",
                                   "weight": 0.005, "enable": True},
            }

    def _rkey(self, modules: Dict[str, Any]) -> str:
        if self.reg_key is None:
            named = [k for k in ("cine_registraion", "cine_registration",
                                 "registration") if k in modules]
            self.reg_key = named[0] if named else \
                [k for k in modules if k != "LMA"][0]
        return self.reg_key

    def make_loader(self, dataset, batch_size: int, shuffle: bool,
                    seed: int = 0):
        max_pairs = min(self.n_video_frames,
                        max(len(dataset.get_slice(i))
                            for i in range(dataset.get_n_slices())))
        return SliceBatcher(dataset, slices_per_batch=batch_size,
                            max_pairs_per_slice=max_pairs, shuffle=shuffle,
                            seed=seed)

    def _make_video(self, disp_flat: torch.Tensor, sp: Tuple[int, int]
                    ) -> torch.Tensor:
        """(S*P, 2, H, W) -> (S, 2, F, H, W), zero-padded or cut to
        F = ``n_video_frames``."""
        s, p = sp
        disp = disp_flat.reshape(s, p, 2, *disp_flat.shape[-2:])
        disp = disp.transpose(1, 2)                          # (S, 2, P, H, W)
        f = self.n_video_frames
        if p < f:
            pad = disp.new_zeros(*disp.shape[:2], f - p, *disp.shape[3:])
            return torch.cat([disp, pad], dim=2)
        return disp[:, :, :f]

    def example_model_args(self, modules: Dict[str, Any],
                           arrays: Dict[str, torch.Tensor]
                           ) -> Dict[str, tuple]:
        """The flattened (src, tar) pairs for the registration model; for
        ``LMA`` the video of a zero displacement (S*P, 2, H, W)."""
        s, p = arrays["source_img"].shape[:2]
        src = _flatten_pairs(arrays["source_img"])
        tar = _flatten_pairs(arrays["target_img"])
        disp = src.new_zeros(src.shape[0], 2, *src.shape[-2:])
        return {self._rkey(modules): (src, tar),
                "LMA": (self._make_video(disp, (s, p)),)}

    def forward(self, modules: Dict[str, Any], arrays: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        s, p = arrays["source_img"].shape[:2]
        src = _flatten_pairs(arrays["source_img"])
        tar = _flatten_pairs(arrays["target_img"])
        reg_out = modules[self._rkey(modules)](src, tar)

        disp = reg_out["displacement"]                       # (S*P, 2, H, W)
        if self.mask_displacement and "source_mask" in arrays:
            disp = disp * torch.maximum(_flatten_pairs(arrays["source_mask"]),
                                        _flatten_pairs(arrays["target_mask"]))
        pair_mask = arrays["pair_mask"].reshape(s * p)
        disp = disp * pair_mask[:, None, None, None]         # padded pairs: 0

        video = self._make_video(disp, (s, p))
        preds = {
            "deformed_source": reg_out["deformed_source"],
            "velocity": reg_out["velocity"],
            "momentum": reg_out["momentum"],
            "displacement_field_X": reg_out["displacement"][:, 1:2],
            "displacement_field_Y": reg_out["displacement"][:, 0:1],
            "pred_displacement_fields": video,
            **modules["LMA"](video),
        }
        # the slice mask for the label losses, the pair mask for the
        # per-pair registration losses (each conf's "mask" picks one)
        targets = {"registration_target": tar,
                   "sample_mask": arrays["sample_mask"],
                   "pair_sample_mask": pair_mask}
        for k in ("TOS", "sector_LMA_labels", "slice_LMA_label"):
            if k in arrays:
                targets[k] = arrays[k][:, 0]      # one label per slice
        if "displacement_field_X" in arrays:      # DENSE supervision
            for k in ("displacement_field_X", "displacement_field_Y"):
                targets[k] = _flatten_pairs(arrays[k])
        return preds, targets
