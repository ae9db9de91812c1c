"""Hand-written Hopper kernels of the serving and training paths and their
plain versions.

=====  ============================  ==================================
TC     ``conv3d.conv3d_tc``           ``csrc/conv3d_tc.cu`` (bf16 k3/k5,
                                      tensor cores: K1, K6, K5 in bf16)
UTC    ``upsample_tc.upconv_tc``      ``csrc/upconv_tc.cu`` (bf16 stride-2
                                      upsampling, tensor cores: K3, K7a,
                                      K7b)
TCQ    ``conv3d.conv3d_tc_q``         ``csrc/conv3d_tc_q.cu`` (int8 k3 conv,
                                      int8 tensor cores: K1q, K4a)
UTCQ   ``upsample_tc.upconv_tc_q``    ``csrc/upconv_tc_q.cu`` (int8 K3,
                                      int8 tensor cores: K3q, K4b)
TCF    ``conv3d.conv3d_tc_f32``       ``csrc/conv3d_tc_f32.cu`` (f32 k3/k5,
                                      tensor cores on split tf32
                                      operands: K1, K6, K5 in f32)
UTCF   ``upsample_tc.upconv_tc_f32``  ``csrc/upconv_tc_f32.cu`` (f32 stride-2
                                      upsampling, tensor cores on split
                                      tf32 operands: K3, K7a, K7b in f32)
F32    ``conv3d.conv3d_f32``          ``csrc/conv3d_tc_f32.cu`` (f32 k3
                                      conv: K1, K6 in f32)
F32K5  ``conv3d.conv3d5_f32``         ``csrc/conv3d_tc_f32.cu`` (f32 k5
                                      conv: K5 in f32)
POOL   ``conv3d.maxpool2_rows``       ``csrc/maxpool_rows.cu`` (2x2x2 max
                                      pool streamed by rows: K2 in bf16
                                      and f32, K2q in int8)
F32P   ``conv3d.maxpool2_f32``        ``csrc/maxpool_rows.cu`` (f32: K2 in
                                      f32)
F32U   ``upconv.upconv_f32``          ``csrc/upconv_tc_f32.cu`` (f32: K3 in
                                      f32)
F32T   ``convt.convt_f32``            ``csrc/upconv_tc_f32.cu`` (f32: K7a,
                                      K7b in f32)
K1     ``conv3d.conv3d_bn_relu``      bf16: ``csrc/conv3d_tc.cu``; f32:
                                      ``csrc/conv3d_tc_f32.cu``
K2     ``conv3d.maxpool2``            ``csrc/maxpool_rows.cu`` (bf16,
                                      f32)
K3     ``upconv.upconv_bn_relu``      bf16: ``csrc/upconv_tc.cu``; f32:
                                      ``csrc/upconv_tc_f32.cu``
K1q    ``conv3d.conv3d_q_requant``    ``csrc/conv3d_tc_q.cu``
K2q    ``conv3d.maxpool2_q``          ``csrc/maxpool_rows.cu`` (int8)
K3q    ``upconv.upconv_q_requant``    ``csrc/upconv_tc_q.cu``
K6     ``conv3d.conv3d_bias_act``     bf16: ``csrc/conv3d_tc.cu``; f32:
                                      ``csrc/conv3d_tc_f32.cu`` (ReLU
                                      flag)
K5     ``conv3d.conv3d5_bias_act``    bf16: ``csrc/conv3d_tc.cu``; f32:
                                      ``csrc/conv3d_tc_f32.cu`` (k=5)
K7a    ``convt.convt_k2s2``           bf16: ``csrc/upconv_tc.cu``; f32:
                                      ``csrc/upconv_tc_f32.cu``
K7b    ``convt.convt_k2s2_dual``      as K7a (concat of two)
ADAM   ``adam.adam_mt``               ``csrc/adam_mt.cu`` (the f32 Adam /
                                      AdamW update of many leaves in one
                                      launch; no TPU counterpart)
=====  ============================  ==================================

Each wrapper counts its launches, and so does the kernel function it
launches through (``conv3d_tc``, ``upconv_tc``, ``conv3d_tc_q``,
``upconv_tc_q``, ``maxpool2_rows``, or in f32 ``conv3d_f32`` /
``conv3d5_f32`` and under both ``conv3d_tc_f32``, ``maxpool2_f32`` and
under it ``maxpool2_rows``, ``upconv_f32`` / ``convt_f32`` and under both
``upconv_tc_f32``), so a run can show which kernel served each dtype. The
kernels that K1/K6/K5 (``conv3d.cu``, ``conv3d_k5.cu``), K3
(``upconv.cu``) and K7a/K7b (``convt.cu``) launched before the tensor-core
kernels, bf16 and f32, K1q (``conv3d_q.cu``) and K3q (``upconv_q.cu``) in
int8, and K2/K2q (``maxpool.cu``: ``maxpool2_direct``,
``maxpool2_f32_direct``, ``maxpool2_q_direct``) before the row-streaming
pool, stay reachable as ``*_direct`` functions, which count no
launches.

Importing this package builds nothing and needs neither ``nvcc`` nor a
card; a kernel is compiled at its first launch (``build.py``).
"""

from __future__ import annotations

from typing import Dict

from .adam import adam_mt
from .conv3d import (conv3d5_bias_act, conv3d5_f32, conv3d_bias_act,
                     conv3d_bn_relu, conv3d_f32, conv3d_q_requant, conv3d_tc,
                     conv3d_tc_f32, conv3d_tc_q, maxpool2, maxpool2_f32,
                     maxpool2_q, maxpool2_rows)
from .convt import convt_f32, convt_k2s2, convt_k2s2_dual
from .upconv import upconv_bn_relu, upconv_f32, upconv_q_requant
from .upsample_tc import upconv_tc, upconv_tc_f32, upconv_tc_q

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
    "conv3d_tc_q": conv3d_tc_q,
    "upconv_tc_q": upconv_tc_q,
    "conv3d_tc_f32": conv3d_tc_f32,
    "conv3d_f32": conv3d_f32,
    "conv3d5_f32": conv3d5_f32,
    "maxpool2_f32": maxpool2_f32,
    "upconv_f32": upconv_f32,
    "convt_f32": convt_f32,
    "upconv_tc_f32": upconv_tc_f32,
    "maxpool2_rows": maxpool2_rows,
    "adam_mt": adam_mt,
}


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches() -> Dict[str, int]:
    """Each wrapper's launch count since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}
