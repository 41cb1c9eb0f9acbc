"""The port's ops layer: counterparts of ``cardiax.ops``, under its names
(the strain ops, ``FluidMetric`` and ``svd_denoise`` are not ported)."""

from cardiax_torch.ops.fluid_metric import flat, sharp
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
    "flat", "sharp",
    "ad_star", "deform_image", "expmap_shooting", "expmap_svf",
    "subspace_denoise",
    "bilinear_warp", "compose_displacements", "warp_vector_field",
]
