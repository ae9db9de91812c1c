"""Hand-written Hopper kernels of the serving and training paths and their
plain versions.

=====  ============================  ==================================
TC     ``conv3d.conv3d_tc``           ``csrc/conv3d_tc.cu`` (bf16 k3/k5,
                                      tensor cores: K1, K6, K5 in bf16)
UTC    ``upsample_tc.upconv_tc``      ``csrc/upconv_tc.cu`` (bf16 stride-2
                                      upsampling, tensor cores: K3, K7a,
                                      K7b)
K1     ``conv3d.conv3d_bn_relu``      ``csrc/conv3d_tc.cu``
K2     ``conv3d.maxpool2``            ``csrc/maxpool.cu``
K3     ``upconv.upconv_bn_relu``      ``csrc/upconv_tc.cu``
K1q    ``conv3d.conv3d_q_requant``    ``csrc/conv3d_q.cu``
K2q    ``conv3d.maxpool2_q``          ``csrc/maxpool.cu`` (int8)
K3q    ``upconv.upconv_q_requant``    ``csrc/upconv_q.cu``
K6     ``conv3d.conv3d_bias_act``     bf16: ``csrc/conv3d_tc.cu``; f32:
                                      ``csrc/conv3d.cu`` (ReLU flag)
K5     ``conv3d.conv3d5_bias_act``    bf16: ``csrc/conv3d_tc.cu``; f32:
                                      ``csrc/conv3d_k5.cu`` (k=5)
K7a    ``convt.convt_k2s2``           ``csrc/upconv_tc.cu``
K7b    ``convt.convt_k2s2_dual``      ``csrc/upconv_tc.cu`` (concat of two)
=====  ============================  ==================================

The CUDA-core kernels that K1/K6/K5 (``conv3d.cu``, ``conv3d_k5.cu``), K3
(``upconv.cu``) and K7a/K7b (``convt.cu``) launched in bf16 before the
tensor-core kernels stay reachable as ``*_direct`` functions, which count
no launches.

Importing this package builds nothing and needs neither ``nvcc`` nor a
card; a kernel is compiled at its first launch (``build.py``).
"""

from __future__ import annotations

from typing import Dict

from .conv3d import (conv3d5_bias_act, conv3d_bias_act, conv3d_bn_relu,
                     conv3d_q_requant, conv3d_tc, maxpool2, maxpool2_q)
from .convt import convt_k2s2, convt_k2s2_dual
from .upconv import upconv_bn_relu, upconv_q_requant
from .upsample_tc import upconv_tc

WRAPPERS = {
    "conv3d_bn_relu": conv3d_bn_relu,
    "maxpool2": maxpool2,
    "upconv_bn_relu": upconv_bn_relu,
    "conv3d_q_requant": conv3d_q_requant,
    "maxpool2_q": maxpool2_q,
    "upconv_q_requant": upconv_q_requant,
    "conv3d_bias_act": conv3d_bias_act,
    "conv3d5_bias_act": conv3d5_bias_act,
    "convt_k2s2": convt_k2s2,
    "convt_k2s2_dual": convt_k2s2_dual,
    "conv3d_tc": conv3d_tc,
    "upconv_tc": upconv_tc,
}


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches() -> Dict[str, int]:
    """Each wrapper's launch count since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}
