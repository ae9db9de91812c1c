"""Operations and bytes of the generic U-Net family, counted from a
configuration's widths and canvas.

The layers are the serving engine's (BatchNorm folded into the convs):
the input stack, two conv units and a pool per encoder level, then per
decoder block the upsampling fused with its first conv unit and the
second conv unit, then the 1x1 head. Operations count a multiply and an
add as two; a conv counts all 27 taps of every output voxel. Bytes count
each layer reading its inputs and weights once and writing its output
once, in the serving dtype (``dtype_bytes``); the input volume arrives
in f32. It is the same work whatever implements it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

TAPS = 27  # a 3x3x3 conv


def widths(spec: Dict) -> List[int]:
    return [spec["i_size"] * 2 ** i for i in range(spec["n_blocks"])]


def layers(spec: Dict, canvas: Sequence[int], dtype_bytes: int = 2
           ) -> List[Dict]:
    """``[{"name", "ops", "bytes"}]`` of one volume's serving pass."""
    n, ws = spec["n_blocks"], widths(spec)
    vox = [math.prod(canvas) // 8 ** i for i in range(n + 1)]
    b = dtype_bytes
    out = []

    def conv(name, v, ci, co):
        out.append(dict(name=name, ops=2 * v * TAPS * ci * co,
                        bytes=b * (v * (ci + co) + TAPS * ci * co)))

    cin = spec["input_channels"]
    # the f32 volume and the atlas in, the stacked input out
    out.append(dict(name="input", ops=0,
                    bytes=vox[0] * (4 + b + cin * b)))
    for i, w in enumerate(ws):
        conv(f"d{i}.unit0", vox[i], cin, w)
        conv(f"d{i}.unit1", vox[i], w, w)
        out.append(dict(name=f"d{i}.pool", ops=0,
                        bytes=b * w * (vox[i] + vox[i + 1])))
        cin = w
    for j in range(n):
        lvl = n - 1 - j
        w = ws[lvl]
        vin, vout = vox[lvl + 1], vox[lvl]
        # ConvT(k2, s2) of the whole input (width cin) fused with unit 0
        out.append(dict(
            name=f"u{j}.upconv",
            ops=2 * vin * cin * cin * 8 + 2 * vout * TAPS * cin * w,
            bytes=b * (vin * cin + vout * w + 8 * cin * cin
                       + TAPS * cin * w)))
        conv(f"u{j}.unit1", vout, w, w)
        cin = 2 * w
    heads_bytes = 4 if spec["head"] == "double_softmax" else b
    out_ch = spec["out_channels"]
    out.append(dict(
        name="head",
        ops=2 * vox[0] * cin * out_ch + 2 * vox[0] * out_ch * 2 * 2,
        bytes=b * vox[0] * cin + heads_bytes * vox[0] * 2 * 2))
    return out


def forward_flops(spec: Dict, canvas: Sequence[int]) -> int:
    """Model FLOPs of one volume's forward pass: every conv, ConvTranspose
    and the 1x1 head's product (the head's 3x2 maps are not counted)."""
    n, ws = spec["n_blocks"], widths(spec)
    v0 = math.prod(canvas)
    total, cin = 0, spec["input_channels"]
    for i, w in enumerate(ws):
        v = v0 // 8 ** i
        total += 2 * v * TAPS * (cin * w + w * w)
        cin = w
    for j in range(n):
        lvl = n - 1 - j
        w, vout = ws[lvl], v0 // 8 ** lvl
        total += 2 * (vout // 8) * cin * cin * 8
        total += 2 * vout * TAPS * (cin * w + w * w)
        cin = 2 * w
    return total + 2 * v0 * cin * spec["out_channels"]


def first_conv_flops(spec: Dict, canvas: Sequence[int]) -> int:
    return 2 * math.prod(canvas) * TAPS * spec["input_channels"] * \
        spec["i_size"]


def train_flops(spec: Dict, canvas: Sequence[int]) -> int:
    """FLOPs of one training step at batch 1: the forward, the input
    gradient of every layer but the network input's first conv, and every
    weight gradient (each as many as the layer's forward)."""
    fwd = forward_flops(spec, canvas)
    return 3 * fwd - first_conv_flops(spec, canvas)


def least_seconds(rows: List[Dict], flop_per_s: float,
                  bytes_per_s: float) -> float:
    """The pass's least time: the larger of its operations at the peak
    rate and its bytes at the memory bandwidth."""
    ops = sum(r["ops"] for r in rows)
    nbytes = sum(r["bytes"] for r in rows)
    return max(ops / flop_per_s, nbytes / bytes_per_s)
