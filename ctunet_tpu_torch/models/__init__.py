import torch
from torch import nn

from .. import registry
from .legacy import RecAEv2Fixed, UNet4_2IC
from .unet import CenterBlock, ConvUnit, ResidualBlock, UNet, UNetBlock
from .variants import (UNet4b1i3o, UNet4b2i3o, UNet5b2i3o, UNetDO, UNetSP,
                       UNetSPSmall, double_out_head)


# the ``param_dtype`` values the JAX package builds models with
# (``ctunet_tpu/models/__init__.py:14-27``)
PARAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}


def parse_param_dtype(name) -> torch.dtype:
    """The ``param_dtype`` setting as a dtype (unset: ``float32``)."""
    name = name or "float32"
    if name not in PARAM_DTYPES:
        raise ValueError(f"param_dtype {name!r}: one of {list(PARAM_DTYPES)}")
    return PARAM_DTYPES[name]


# input channels of each registered model (the atlas models: 2) and the
# models whose forward returns the (full skull, flap) pair
# (``ctunet_tpu/models/__init__.py:32-44``)
MODEL_INPUT_CHANNELS = {
    "UNet4b2i3o": 2,
    "UNet5b2i3o": 2,
    "UNet4b1i3o": 1,
    "UNetSP": 2,
    "UNetSPSmall": 2,
    "UNetDO": 1,
    "recAE_v2_fixed": 1,
    "UNet4_2IC": 2,
}
DOUBLE_OUTPUT_MODELS = {"UNetSP", "UNetSPSmall", "UNetDO"}


def build_model(name: str, param_dtype: torch.dtype = torch.float32):
    """Instantiate a registered model by config name, its conv,
    ConvTranspose and head parameters held in ``param_dtype`` as flax
    creates them; the BatchNorm scale and shift, like its running
    statistics, stay f32 (the JAX ``BatchNorm`` creates them in f32
    whatever ``param_dtype``, ``ctunet_tpu/models/unet.py:42-89``)."""
    model = registry.get_model(name)()
    for m in model.modules():
        if not isinstance(m, nn.modules.batchnorm._BatchNorm):
            for p in m.parameters(recurse=False):
                p.data = p.data.to(param_dtype)
    return model


__all__ = [
    "CenterBlock",
    "ConvUnit",
    "DOUBLE_OUTPUT_MODELS",
    "MODEL_INPUT_CHANNELS",
    "RecAEv2Fixed",
    "ResidualBlock",
    "UNet",
    "UNetBlock",
    "UNet4b1i3o",
    "UNet4_2IC",
    "UNet4b2i3o",
    "UNet5b2i3o",
    "UNetDO",
    "UNetSP",
    "UNetSPSmall",
    "build_model",
    "double_out_head",
    "parse_param_dtype",
]
