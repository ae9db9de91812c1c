from .. import registry
from .legacy import RecAEv2Fixed, UNet4_2IC
from .unet import UNet, UNetBlock
from .variants import UNet4b1i3o, UNet4b2i3o, UNetDO, UNetSP, double_out_head


def build_model(name: str):
    """Instantiate a registered model by config name (f32 parameters)."""
    return registry.get_model(name)()


__all__ = [
    "RecAEv2Fixed",
    "UNet",
    "UNetBlock",
    "UNet4b1i3o",
    "UNet4_2IC",
    "UNet4b2i3o",
    "UNetDO",
    "UNetSP",
    "build_model",
    "double_out_head",
]
