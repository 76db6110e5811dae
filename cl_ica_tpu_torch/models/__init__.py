from .layers import RescaleLayer, SoftclipLayer, smooth_leaky_relu
from .invertible import InvertibleMLP, construct_invertible_mlp
from .mlp import MLPEncoder, get_mlp
from .convert import encoder_params_from_flax, encoder_params_to_flax

__all__ = [
    "RescaleLayer",
    "SoftclipLayer",
    "smooth_leaky_relu",
    "InvertibleMLP",
    "construct_invertible_mlp",
    "MLPEncoder",
    "get_mlp",
    "encoder_params_from_flax",
    "encoder_params_to_flax",
]
