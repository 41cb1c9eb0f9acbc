"""JointRegisterStrainMatNet: the flagship registration + strain model.

Counterpart of ``cardiax/models/joint_net.py:JointRegisterStrainMatNet.
forward_volume``:

    forward_volume(src_vol (B,1,P,H,W), tar_vol (B,1,P,H,W)) -> {
        'strain_matrix':   (B, 1, n_sectors, n_strain_matrix_frames),
        'deformed_source': (B, 1, P, H, W),
        'velocity':        (B, 2, P, H, W),
        'momentum':        (B, 2, P, H, W),
        'displacement':    (B, P, 2, H, W),
    }

The P frame pairs fold into the batch for the momentum UNet and the
shooting (kernels K2/K3 per Euler step), the final image warp is kernel K1
(backward K4, d/d displacement only: the source frames are data), the
displacement regroups into a motion video for the strain head (on the
integration grid when ``strain_downsample`` allows), and the strain matrix
is smoothed by rank-k subspace iteration. ``n_pairs`` (P) sizes the
``ResNet3D`` strain head's frame projection, which flax creates at first
call. ``strainmat_net_type="analytic"`` has no strain head (no parameters
but the momentum UNet's, as in flax): the Green-Lagrange circumferential
strain of the full-resolution displacements (``ops/strain.py``), resampled
from the P pair frames to the strain matrix's frames by a fixed hat matrix.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from cardiax_torch.models.strain_net import ResNet3DStrainHead
from cardiax_torch.models.unet import MomentumUNet
from cardiax_torch.ops.fluid_metric import spectral_resize
from cardiax_torch.ops.shooting import deform_image, expmap_shooting
from cardiax_torch.ops.strain import strain_matrix_from_displacements
from cardiax_torch.ops.svd_smooth import subspace_denoise


class JointRegisterStrainMatNet(nn.Module):
    def __init__(self, n_pairs: Optional[int],
                 strainmat_net_type: str = "ResNet3D",
                 n_strain_matrix_frames: int = 40,
                 strainmat_smoothing_method: str = "SVD",
                 strainmat_smoothing_SVD_rank: int = 5,
                 strainmat_smoothing_iters: int = 4, n_sectors: int = 126,
                 reg_features: int = 16, reg_levels: int = 3,
                 alpha: float = 2.0, gamma: float = 1.0, fluid_power: int = 2,
                 n_integration_steps: int = 5, shoot_downsample: int = 2,
                 reg_half_res: bool = True, strain_downsample: int = 2,
                 final_warp_radius: int = 12, strain_features: int = 16,
                 exact_warp: bool = False):
        super().__init__()
        self.analytic = strainmat_net_type == "analytic"
        self.n_sectors = n_sectors
        self.n_strain_matrix_frames = n_strain_matrix_frames
        self.smoothing = strainmat_smoothing_method
        self.svd_rank = strainmat_smoothing_SVD_rank
        self.svd_iters = strainmat_smoothing_iters
        self.alpha, self.gamma, self.fluid_power = alpha, gamma, fluid_power
        self.n_integration_steps = n_integration_steps
        self.shoot_downsample = shoot_downsample
        self.strain_downsample = strain_downsample
        self.final_warp_radius = final_warp_radius
        self.exact_warp = exact_warp
        self.momentum_unet = MomentumUNet(reg_features, reg_levels,
                                          half_res=reg_half_res)
        self.strain_head = None if self.analytic else ResNet3DStrainHead(
            n_sectors, strain_features, in_frames=n_pairs,
            out_frames=n_strain_matrix_frames)

    def forward(self, src_vol, tar_vol) -> Dict[str, torch.Tensor]:
        return self.forward_volume(src_vol, tar_vol)

    def _analytic_strain(self, disp_video: torch.Tensor,
                         mask0: torch.Tensor) -> torch.Tensor:
        """disp_video (B, P, 2, H, W), mask0 (B, H, W) -> (B, S, Ts): the
        strain of each pair frame, then a fixed linear resample in time in
        which strain frame 0 is the (zero-strain) reference and the pairs
        cover 1..P. The (P, Ts) hat matrix is built on the device (arange
        only: no host copy, so a CUDA graph can capture it)."""
        p, ts = disp_video.shape[1], self.n_strain_matrix_frames
        strain_p = strain_matrix_from_displacements(
            disp_video.transpose(1, 2), mask0, self.n_sectors)   # (B, S, P)
        dev = disp_video.device
        src_pos = torch.arange(1, p + 1, dtype=torch.float32, device=dev)
        # jnp.linspace(0, p, ts): stop * (i / (ts - 1))
        dst_pos = torch.arange(ts, dtype=torch.float32, device=dev) \
            / max(ts - 1, 1) * float(p)
        m = (1.0 - (dst_pos[None, :] - src_pos[:, None]).abs()).clamp(0.0, 1.0)
        m = m / m.sum(0, keepdim=True).clamp_min(1e-6)
        return strain_p @ m

    def forward_volume(self, src_vol: torch.Tensor, tar_vol: torch.Tensor
                       ) -> Dict[str, torch.Tensor]:
        b, _, p, h, w = src_vol.shape
        src = src_vol.reshape(b * p, 1, h, w)
        tar = tar_vol.reshape(b * p, 1, h, w)
        x = torch.cat([src, tar], dim=1).permute(0, 2, 3, 1)   # (B*P, H, W, 2)
        m0 = self.momentum_unet(x).permute(0, 3, 1, 2).contiguous()
        u_inv, v0, u_low = expmap_shooting(
            m0, alpha=self.alpha, gamma=self.gamma, power=self.fluid_power,
            n_steps=self.n_integration_steps,
            warp_radius=None if self.exact_warp else 8,
            shoot_downsample=self.shoot_downsample, return_low=True)
        deformed = deform_image(src.contiguous(), u_inv,
                                warp_radius=None if self.exact_warp
                                else self.final_warp_radius,
                                img_const=True)

        disp_video = u_inv.reshape(b, p, 2, h, w)
        ds = int(self.strain_downsample)
        if self.analytic:                 # the shared frame 0 as the mask
            strain = self._analytic_strain(disp_video, src_vol[:, 0, 0])
        elif ds > 1 and h % ds == 0 and w % ds == 0 and min(h, w) >= 16 * ds:
            if u_low is not None and u_low.shape[-2:] == (h // ds, w // ds):
                small = u_low     # shooting already ran on this grid
            else:
                small = spectral_resize(u_inv, (h // ds, w // ds))
            strain = self.strain_head(
                small.reshape(b, p, 2, h // ds, w // ds).permute(0, 1, 3, 4, 2))
        else:
            strain = self.strain_head(disp_video.permute(0, 1, 3, 4, 2))
        if self.smoothing == "SVD":
            strain = subspace_denoise(strain, self.svd_rank,
                                      n_iters=self.svd_iters)
        return {
            "strain_matrix": strain[:, None],
            "deformed_source": deformed.reshape(b, 1, p, h, w),
            "velocity": v0.reshape(b, 2, p, h, w),
            "momentum": m0.reshape(b, 2, p, h, w),
            "displacement": disp_video,
        }
