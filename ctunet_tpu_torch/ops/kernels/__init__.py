"""Hand-written Hopper kernels of the serving and training paths and their
plain versions.

=====  ============================  ==================================
K1     ``conv3d.conv3d_bn_relu``      ``csrc/conv3d.cu``
K2     ``conv3d.maxpool2``            ``csrc/maxpool.cu``
K3     ``upconv.upconv_bn_relu``      ``csrc/upconv.cu``
K1q    ``conv3d.conv3d_q_requant``    ``csrc/conv3d_q.cu``
K2q    ``conv3d.maxpool2_q``          ``csrc/maxpool.cu`` (int8)
K3q    ``upconv.upconv_q_requant``    ``csrc/upconv_q.cu``
K6     ``conv3d.conv3d_bias_act``     ``csrc/conv3d.cu`` (bf16/f32, ReLU flag)
=====  ============================  ==================================

Importing this package builds nothing and needs neither ``nvcc`` nor a
card; a kernel is compiled at its first launch (``build.py``).
"""

from __future__ import annotations

from typing import Dict

from .conv3d import (conv3d_bias_act, conv3d_bn_relu, conv3d_q_requant,
                     maxpool2, maxpool2_q)
from .upconv import upconv_bn_relu, upconv_q_requant

WRAPPERS = {
    "conv3d_bn_relu": conv3d_bn_relu,
    "maxpool2": maxpool2,
    "upconv_bn_relu": upconv_bn_relu,
    "conv3d_q_requant": conv3d_q_requant,
    "maxpool2_q": maxpool2_q,
    "upconv_q_requant": upconv_q_requant,
    "conv3d_bias_act": conv3d_bias_act,
}


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches() -> Dict[str, int]:
    """Each wrapper's launch count since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}
