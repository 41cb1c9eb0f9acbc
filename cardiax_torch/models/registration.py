"""RegistrationNet: pairwise diffeomorphic registration of two frames.

Counterpart of ``cardiax/models/registration.py:RegistrationNet``
(``channel_pack`` off, as for the joint network):

    forward(src (B,1,H,W), tar (B,1,H,W)) -> {
        'displacement':    (B,2,H,W),   # phi^{-1} - id (pull-back field)
        'velocity':        (B,2,H,W),   # v0 = K m0
        'momentum':        (B,2,H,W),   # m0
        'deformed_source': (B,1,H,W),   # src o phi^{-1}
    }

The momentum UNet sees the concatenated pair; the shooting integrates on
the ``shoot_downsample`` grid with the in-scan radius min(2, 8) = 2
(kernels K2/K3 per Euler step); the final warp of the source is kernel K1
forward and K4 backward (``img_const``: the source frames are data).
``exact_warp=True`` takes the unclamped gathers instead.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from cardiax_torch.models.unet import MomentumUNet
from cardiax_torch.ops.shooting import deform_image, expmap_shooting


class RegistrationNet(nn.Module):
    def __init__(self, features: int = 16, n_levels: int = 3,
                 alpha: float = 2.0, gamma: float = 1.0, fluid_power: int = 2,
                 n_integration_steps: int = 5, shoot_downsample: int = 2,
                 reg_half_res: bool = True, final_warp_radius: int = 12,
                 exact_warp: bool = False):
        super().__init__()
        self.alpha, self.gamma, self.fluid_power = alpha, gamma, fluid_power
        self.n_integration_steps = n_integration_steps
        self.shoot_downsample = shoot_downsample
        self.final_warp_radius = final_warp_radius
        self.exact_warp = exact_warp
        self.momentum_unet = MomentumUNet(features, n_levels,
                                          half_res=reg_half_res)

    def forward(self, src: torch.Tensor, tar: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        x = torch.cat([src, tar], dim=1).permute(0, 2, 3, 1)   # (B, H, W, 2)
        m0 = self.momentum_unet(x).permute(0, 3, 1, 2).contiguous()
        u_inv, v0 = expmap_shooting(
            m0, alpha=self.alpha, gamma=self.gamma, power=self.fluid_power,
            n_steps=self.n_integration_steps,
            warp_radius=None if self.exact_warp else 8,
            shoot_downsample=self.shoot_downsample)
        deformed = deform_image(src.contiguous(), u_inv,
                                warp_radius=None if self.exact_warp
                                else self.final_warp_radius,
                                img_const=True)
        return {"displacement": u_inv, "velocity": v0, "momentum": m0,
                "deformed_source": deformed}
