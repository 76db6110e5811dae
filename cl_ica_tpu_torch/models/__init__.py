from .layers import (
    FastBatchNorm2d,
    RescaleLayer,
    SoftclipLayer,
    StemBNReLUPool,
    smooth_leaky_relu,
)
from .invertible import InvertibleMLP, construct_invertible_mlp
from .mlp import MLPEncoder, get_mlp
from .resnet import (
    BasicBlock,
    Bottleneck,
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
)
from .convert import (
    encoder_params_from_flax,
    encoder_params_to_flax,
    resnet_params_from_flax,
    resnet_params_to_flax,
    threedident_params_from_flax,
    threedident_params_to_flax,
)

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
    "FastBatchNorm2d",
    "StemBNReLUPool",
    "BasicBlock",
    "Bottleneck",
    "ResNet",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "ResNet101",
    "ResNet152",
    "resnet_params_from_flax",
    "resnet_params_to_flax",
    "threedident_params_from_flax",
    "threedident_params_to_flax",
]
