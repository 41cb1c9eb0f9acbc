"""The port's ops layer: counterparts of ``cardiax.ops``, under its names
and with its signatures (the strain ops and ``svd_denoise`` are not
ported)."""

from cardiax_torch.ops.fluid_metric import FluidMetric, flat, sharp
from cardiax_torch.ops.shooting import (
    ad_star,
    deform_image,
    expmap_shooting,
    expmap_svf,
)
from cardiax_torch.ops.svd_smooth import subspace_denoise
from cardiax_torch.ops.warp import (bilinear_warp, compose_displacements,
                                    warp_vector_field)

__all__ = [
    "FluidMetric", "flat", "sharp",
    "ad_star", "deform_image", "expmap_shooting", "expmap_svf",
    "subspace_denoise",
    "bilinear_warp", "compose_displacements", "warp_vector_field",
]
