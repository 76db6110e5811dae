from .layers import (
    FastBatchNorm2d,
    MinResBN2d,
    MinResBNPool,
    RescaleLayer,
    SoftclipLayer,
    StemBNReLUPool,
    smooth_leaky_relu,
)
from .invertible import InvertibleMLP, construct_invertible_mlp
from .mlp import MLPEncoder, get_mlp
from .conv import ConvEncoder64
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
    conv_encoder_params_from_flax,
    conv_encoder_params_to_flax,
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
    "ConvEncoder64",
    "conv_encoder_params_from_flax",
    "conv_encoder_params_to_flax",
    "encoder_params_from_flax",
    "encoder_params_to_flax",
    "FastBatchNorm2d",
    "MinResBN2d",
    "MinResBNPool",
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
