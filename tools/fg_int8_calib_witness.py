"""Is phase 9's low per-volume int8 Dice a matter of calibration?

``chip_smoke.py`` phase 9 serves its 8 broken skulls through one int8
engine, built (scales and AdaQuant rounding) on the first volume's window,
and holds Dice against the plain f32 model on the whole volume on that
calibration volume and pooled over the 8. This script rebuilds that engine
the way ``Model._build_int8`` does (the window crop as the calibration
volume, ``trainer.int8_calib_hint`` as AdaQuant's batch, the settings of
``FlapRecSP2O_serve_int8.ini``), logs every volume's Dice under it, then
builds a second engine the same way on the volume with the lowest flap
Dice and logs that volume's Dice under its own engine. If the second
engine clears phase 4's floors (skull 0.98, flap 0.95) on that volume, the
first engine's loss there comes from calibrating on another volume.

Usage (from the repo root, on one CUDA card; about 6 minutes on an H100)::

    python3 tools/fg_int8_calib_witness.py

The last line of the output is one JSON object with the numbers.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fg_int8_calib_witness: no CUDA device visible",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from ctunet_tpu_torch import default_params, engine_q, load_params
    from ctunet_tpu_torch.checkpoint import UNETSP_10K, load_any
    from ctunet_tpu_torch.models import build_model
    from ctunet_tpu_torch.ops import foreground
    from ctunet_tpu_torch.ops.kernels import build
    from ctunet_tpu_torch.trainer import (_DTYPES, int8_calib_hint,
                                          paste_window)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device, shape = torch.device("cuda", 0), cs.SHAPE
    card = cs.card_line()
    cs.log(card)
    build.build()
    p = load_params(cs.INT8_INI, default_params())
    margin = int(p["fg_margin"])
    vols = cs.fg_skulls(shape)
    atlas = cs.fg_atlas(shape)
    wins, _, built = cs.fg_expect(vols, margin, 16, int(p["serve_scan"]))
    sd = load_any(UNETSP_10K)
    at = torch.from_numpy(atlas).to(device)
    common = dict(
        compute_dtype=_DTYPES[p.get("compute_dtype") or "bfloat16"],
        device=device,
        calib_quantile=float(p.get("int8_calib_quantile") or 1.0),
        bf16_tail=float(p.get("int8_bf16_tail") or 0),
        bf16_head=float(p.get("int8_bf16_head") or 0),
        adaquant_steps=cs.ADAQUANT_STEPS,
        learn_scales=bool(p.get("int8_learn_scales")))

    def window(i):
        sl = foreground.crop_slices(*wins[i])
        full = torch.from_numpy(vols[i]).to(device, torch.float32)
        return torch.stack([full[sl], at[sl]], -1)[None].to(
            common["compute_dtype"])

    # the plain f32 model's masks on the whole volumes
    model = build_model("UNetSP").to(device).eval()
    model.load_state_dict(sd)
    refs = []
    with torch.inference_mode():
        for v in vols:
            x32 = torch.stack([torch.from_numpy(v).to(device), at], -1)[None]
            refs.append([torch.argmax(o[0], -1).to(torch.uint8).cpu().numpy()
                         for o in model(x32)])
    del model

    def engine(i):
        """The int8 + AdaQuant engine ``Model`` builds when volume ``i``
        is the first served at its window."""
        offs = wins[i][0]
        hint = int8_calib_hint(vols[i][foreground.crop_slices(*wins[i])],
                               atlas, offs, margin)
        t0 = time.perf_counter()
        qfn = engine_q.build_predict_q_opt(
            "UNetSP", sd, window(i)[0].clone(), calib_batch=hint, **common)
        cs.log(f"  engine calibrated on volume {i} at {wins[i][1]} "
               f"(AdaQuant on {tuple(hint.shape[1:])}) in "
               f"{time.perf_counter() - t0:.1f} s")
        return qfn

    def dices(qfn, which):
        out = {"sk": [], "fl": []}
        for i in which:
            with torch.inference_mode():
                outs = qfn(window(i))
            for j, sfx in enumerate(("sk", "fl")):
                win = torch.argmax(outs[j], -1).to(torch.uint8).cpu().numpy()
                got = paste_window(win, vols[i][None], wins[i][0],
                                   shape)[0]
                out[sfx].append(cs.dice(got, refs[i][j]))
        return out

    assert len(built) == 1, built
    everyone = range(len(vols))
    with torch.enable_grad():
        first = dices(engine(0), everyone)
    cs.log(f"  engine of volume 0 (phase 9's): Dice per volume {first}")
    worst = int(np.argmin(first["fl"]))
    with torch.enable_grad():
        own = dices(engine(worst), everyone)
    cs.log(f"  engine of volume {worst}: Dice per volume {own}")
    floors = {"sk": 0.98, "fl": 0.95}
    holds = all(own[s][worst] >= f for s, f in floors.items())
    cs.log(f"  volume {worst}: flap Dice {first['fl'][worst]:.6f} under "
           f"volume 0's engine, {own['fl'][worst]:.6f} under its own "
           f"(floors {floors}); calibration explains it: {holds}")
    cs.log(card)
    print(json.dumps({"card": card, "window": list(built[0]),
                      "worst": worst, "dice_engine_0": first,
                      f"dice_engine_{worst}": own, "floors": floors,
                      "own_engine_clears_floors": holds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
