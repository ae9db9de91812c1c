"""Hand-written Hopper kernels of the serving path and their plain versions.

=====  ==========================  ====================================
K1     ``conv3d.conv3d_bn_relu``    ``csrc/conv3d.cu``
K2     ``conv3d.maxpool2``          ``csrc/maxpool.cu``
K3     ``upconv.upconv_bn_relu``    ``csrc/upconv.cu``
=====  ==========================  ====================================

Importing this package builds nothing and needs neither ``nvcc`` nor a
card; a kernel is compiled at its first launch (``build.py``).
"""

from __future__ import annotations

from typing import Dict

from .conv3d import conv3d_bn_relu, maxpool2
from .upconv import upconv_bn_relu

WRAPPERS = {
    "conv3d_bn_relu": conv3d_bn_relu,
    "maxpool2": maxpool2,
    "upconv_bn_relu": upconv_bn_relu,
}


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches() -> Dict[str, int]:
    """Each wrapper's launch count since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}
