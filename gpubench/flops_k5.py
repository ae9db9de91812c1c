"""Operations and bytes of the legacy k=5 U-Net family (``UNet4_2IC``,
``recAE_v2_fixed``), counted from a configuration's widths and canvas.

The layers are the legacy serving engine's (BatchNorm folded into the
convs): the input stack; per encoder level two k=5 conv units and a pool;
the centre's two conv units; per decoder block the ConvTranspose(k2, s2)
of its whole input and two conv units; the 1x1 head and its softmax.
Operations count a multiply and an add as two; a conv counts all 125 taps
of every output voxel, a ConvTranspose its 8 taps' share of every output
voxel. Bytes count each layer reading its inputs and weights once and
writing its output once, in the serving dtype (``dtype_bytes``); the input
volume arrives in f32. It is the same work whatever implements it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

TAPS = 125  # a 5x5x5 conv


def widths(spec: Dict) -> List[int]:
    """The encoder levels' widths and the centre's last."""
    return [spec["i_size"] * 2 ** i for i in range(spec["n_blocks"] + 1)]


def layers(spec: Dict, canvas: Sequence[int], dtype_bytes: int = 2
           ) -> List[Dict]:
    """``[{"name", "kind", "ops", "bytes"}]`` of one volume's serving pass;
    ``kind`` is ``k5``, ``pool``, ``convt``, ``head`` or ``input``."""
    n, ws = spec["n_blocks"], widths(spec)
    vox = [math.prod(canvas) // 8 ** i for i in range(n + 1)]
    b = dtype_bytes
    out = []

    def conv(name, v, ci, co):
        out.append(dict(name=name, kind="k5", ops=2 * v * TAPS * ci * co,
                        bytes=b * (v * (ci + co) + TAPS * ci * co)))

    cin = spec["input_channels"]
    out.append(dict(name="input", kind="input", ops=0,
                    bytes=vox[0] * (4 + b + cin * b)))
    for i in range(n):
        w = ws[i]
        conv(f"d{i}.unit0", vox[i], cin, w)
        conv(f"d{i}.unit1", vox[i], w, w)
        out.append(dict(name=f"d{i}.pool", kind="pool", ops=0,
                        bytes=b * w * (vox[i] + vox[i + 1])))
        cin = w
    conv("center.unit0", vox[n], cin, ws[n])
    conv("center.unit1", vox[n], ws[n], ws[n])
    cin = ws[n]
    for j in range(n):
        lvl = n - 1 - j
        w, vin, vout = ws[lvl], vox[lvl + 1], vox[lvl]
        out.append(dict(name=f"u{j}.convt", kind="convt",
                        ops=2 * vout * cin * cin,
                        bytes=b * (vin * cin + vout * cin + 8 * cin * cin)))
        conv(f"u{j}.unit0", vout, cin, w)
        conv(f"u{j}.unit1", vout, w, w)
        cin = 2 * w
    out_ch = spec["out_channels"]
    out.append(dict(name="head", kind="head", ops=2 * vox[0] * cin * out_ch,
                    bytes=b * vox[0] * (cin + out_ch)))
    return out


def forward_flops(spec: Dict, canvas: Sequence[int]) -> int:
    """Model FLOPs of one volume's forward pass: every conv, ConvTranspose
    and the 1x1 head's product."""
    return sum(r["ops"] for r in layers(spec, canvas))


def k5_least_seconds(rows: List[Dict], flop_per_s: float,
                     bytes_per_s: float) -> float:
    """The k=5 convs' least time: per launch the larger of its operations
    at the peak rate and its bytes at the memory bandwidth, summed over
    the launches (they run one after another)."""
    return sum(max(r["ops"] / flop_per_s, r["bytes"] / bytes_per_s)
               for r in rows if r["kind"] == "k5")
