"""The port's ops layer: counterparts of ``cardiax.ops``, under its names
and with its signatures."""

from cardiax_torch.ops.fluid_metric import FluidMetric, flat, sharp
from cardiax_torch.ops.shooting import (
    ad_star,
    deform_image,
    expmap_shooting,
    expmap_svf,
)
from cardiax_torch.ops.strain import (
    circumferential_strain,
    sector_matrix,
    strain_matrix_from_displacements,
)
from cardiax_torch.ops.svd_smooth import subspace_denoise, svd_denoise
from cardiax_torch.ops.warp import (bilinear_warp, compose_displacements,
                                    warp_vector_field)

__all__ = [
    "FluidMetric", "flat", "sharp",
    "ad_star", "deform_image", "expmap_shooting", "expmap_svf",
    "circumferential_strain", "sector_matrix", "strain_matrix_from_displacements",
    "subspace_denoise", "svd_denoise",
    "bilinear_warp", "compose_displacements", "warp_vector_field",
]
