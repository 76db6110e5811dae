from .spaces import Space, NRealSpace, NSphereSpace, NBoxSpace
from .latent_spaces import LatentSpace, ProductLatentSpace
from .utils import (
    spherical_to_cartesian,
    cartesian_to_spherical,
    sample_gamma,
    sample_generalized_normal,
    truncated_rejection_resampling,
)
from .vmf import sample_vmf

__all__ = [
    "Space",
    "NRealSpace",
    "NSphereSpace",
    "NBoxSpace",
    "LatentSpace",
    "ProductLatentSpace",
    "spherical_to_cartesian",
    "cartesian_to_spherical",
    "sample_gamma",
    "sample_generalized_normal",
    "truncated_rejection_resampling",
    "sample_vmf",
]
