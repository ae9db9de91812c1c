"""The serving loop: ``mix["volumes"]`` distinct broken skulls in host
memory go round, closed loop, ``prefetch_depth`` volumes in flight (the
serving loop of ``Model._forward_pass_test`` without its file I/O): per
volume ``data.pipeline.upload`` (pinned staging, a ``non_blocking`` copy),
the predict that ``Model`` builds (``_make_whole_volume_predict``: the
atlas channel stacked on the card, then the engine), the argmax to uint8
on the card, and the masks fetched into host memory. A volume's time runs
from the start of its upload to its masks on the host.

It follows whole-volume serving of one volume at a time on the pool
multiple's canvas, and refuses a configuration that sets a serving path
it does not follow (patches, foreground crop, K-volume groups, the
largest-component postprocess, AdaQuant's calibration window).

Mix parameters: ``volumes``, ``warmup`` (volumes served in set-up),
``sample`` (served volumes compared with the reference), ``trace_units``
(volumes in a traced window).
"""

from __future__ import annotations

import collections
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from gpubench import inputs, systems
from gpubench.reference import unet as ref_unet

# serving settings of the package that this loop does not follow, with the
# value it follows
UNFOLLOWED = {"patch_inference": False, "fg_crop": False, "serve_scan": 1,
              "largest_cc": False, "dist_coordinator": ""}

# a served class that the reference puts this far below its best is a
# flip the serving precision does not explain: 4 bf16 steps at 0.5
FLIP_GAP = 2.0 ** -7


class System:
    """The serving loop (module docstring)."""

    def __init__(self, cfg: Dict, mix: Dict, seed: int, device,
                 canvas) -> None:
        self.cfg, self.mix, self.device = cfg, mix, device
        self.canvas = tuple(canvas)
        self.setup_stages = stages = systems.Stages()
        with stages("build"):
            systems.build_kernels(device)
        with stages("model"):
            from ctunet_tpu_torch import trainer
            from ctunet_tpu_torch.data.pipeline import upload

            self._upload = upload
            self._workspace = tempfile.mkdtemp(prefix="gpubench_")
            params = systems.program_params(cfg, device, self._workspace)
            params["resume_model"] = os.path.join(systems.ROOT,
                                                  cfg["weights"])
            systems.refuse(params, UNFOLLOWED)
            if params.get("use_int8") and params.get("int8_adaquant"):
                systems.refuse(params, {"int8_adaquant": False})
            model = trainer.Model(params=params)
            if any(s % model.pool_multiple for s in self.canvas):
                raise NotImplementedError(
                    f"canvas {self.canvas} is not a multiple of "
                    f"{model.pool_multiple}: this loop does not pad")
            model.initialize_models()
        with stages("inputs"):
            self.atlas = inputs.atlas(self.canvas, device)
            self.volumes = inputs.skulls(self.canvas, mix["volumes"], seed,
                                         device, broken=True)
        with stages("engine"):
            self.predict = model._make_whole_volume_predict(self.atlas)
        self.model = model
        self.depth = int(params.get("prefetch_depth") or 2)
        self.pending: collections.deque = collections.deque()
        self.rng = np.random.default_rng(inputs.subseed(seed, 3))
        self.sample: List = []  # (volume index, host masks), a reservoir
        self.seen = 0
        self.i = 0
        # host seconds by stage since the window opened
        self.stages = collections.defaultdict(float)
        with stages("warmup"), torch.inference_mode():
            for _ in range(int(mix["warmup"])):
                self._dispatch()
                if len(self.pending) >= self.depth:
                    self._flush()
            while self.pending:
                self._flush()
            systems.sync(device)
        self.seen, self.sample = 0, []
        self.stages.clear()

    def _dispatch(self) -> None:
        k = self.i % len(self.volumes)
        self.i += 1
        t = time.perf_counter()
        with systems.span("gpubench.upload"):
            up = self._upload(self.volumes[k], self.device, torch.float32)
        t_up = time.perf_counter()
        self.stages["upload"] += t_up - t
        with systems.span("gpubench.predict"):
            out = self.predict(up, None)
        with systems.span("gpubench.argmax"):
            masks = tuple(torch.argmax(o, -1).to(torch.uint8)
                          for o in (out if isinstance(out, tuple)
                                    else (out,)))
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        self.stages["launch"] += time.perf_counter() - t_up
        self.pending.append((k, t, masks, done))

    def _flush(self):
        k, t, masks, done = self.pending.popleft()
        t_wait = time.perf_counter()
        if done is not None:
            with systems.span("gpubench.wait"):
                done.synchronize()
        t_fetch = time.perf_counter()
        with systems.span("gpubench.fetch"):
            host = tuple(m.cpu().numpy() for m in masks)
        t_done = time.perf_counter()
        self.stages["wait"] += t_fetch - t_wait
        self.stages["fetch"] += t_done - t_fetch
        # a reservoir sample, drawn from the seed, of the answers
        cap = int(self.mix["sample"])
        if self.seen < cap:
            self.sample.append((k, host))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < cap:
                self.sample[j] = (k, host)
        self.seen += 1
        return t, t_done

    def window(self, seconds: Optional[float] = None,
               count: Optional[int] = None) -> Dict:
        """Serve for ``seconds`` (or ``count`` volumes); the volumes whose
        masks reached the host within the window count, those still in
        flight when it closes are finished and compared but not counted.
        """
        lat: List[float] = []
        attempted = 0
        with torch.inference_mode():
            t0 = time.perf_counter()
            t_end = t0 + seconds if seconds is not None else float("inf")
            while (time.perf_counter() < t_end if count is None
                   else attempted < count):
                self._dispatch()
                attempted += 1
                if len(self.pending) >= self.depth:
                    t, t_done = self._flush()
                    if t_done <= t_end:
                        lat.append(t_done - t)
            if count is not None:  # a counted window ends with its last
                while self.pending:
                    t, t_done = self._flush()
                    lat.append(t_done - t)
                t_end = time.perf_counter()
            length = t_end - t0
            while self.pending:
                self._flush()
        out = dict(attempted=attempted, completed=len(lat), window_s=length,
                   stage_ms={k: 1e3 * v / max(self.seen, 1)
                             for k, v in self.stages.items()})
        if lat:
            out["serve_volumes_per_s"] = len(lat) / length
            out["serve_p95_ms"] = 1e3 * systems.quantile(lat, 0.95)
            out["latency_ms"] = {f"p{q}": 1e3 * systems.quantile(lat, q / 100)
                                 for q in (50, 90, 99)}
        return out

    def release(self) -> None:
        del self.predict, self.model
        self.pending.clear()
        shutil.rmtree(self._workspace, ignore_errors=True)
        systems.release_memory()

    def check(self) -> Dict[str, float]:
        """The served masks of the sample against the reference's outputs
        on the same inputs: ``gap_max``, the widest gap by which the
        reference's output for a served class lies below its best class's
        (0 where they agree); ``flip_share``, the share of voxels served
        a class that the reference puts more than ``FLIP_GAP`` below its
        best, and ``flip_share_worst``, that share in the worst mask (one
        head of one volume)."""
        spec, dev = self.cfg["model"], self.device
        p, s = ref_unet.split_weights(inputs.read_npz(
            os.path.join(systems.ROOT, self.cfg["weights"]), dev))
        atlas = torch.as_tensor(self.atlas, device=dev)
        by_volume = collections.defaultdict(list)
        for k, host in self.sample:
            by_volume[k].append(host)
        gap_max, flips, voxels, worst = 0.0, 0, 0, 0.0
        with systems.reference_precision(), torch.no_grad():
            for k, served in sorted(by_volume.items()):
                vol = torch.as_tensor(self.volumes[k][0], device=dev)
                x = torch.stack([vol, atlas], -1)[None]
                ref = ref_unet.forward(p, s, x, spec["n_blocks"],
                                       spec["head"])
                del x
                for host in served:
                    for r, m in zip(ref, host):
                        m = torch.as_tensor(m, device=dev).long()[..., None]
                        gap = r.amax(-1) - torch.gather(r, -1, m)[..., 0]
                        gap_max = max(gap_max, float(gap.max()))
                        n = int((gap > FLIP_GAP).sum())
                        worst = max(worst, n / gap.numel())
                        flips += n
                        voxels += gap.numel()
                del ref
        return dict(flip_share_worst=worst,
                    flip_share=flips / max(voxels, 1), gap_max=gap_max,
                    compared=float(len(self.sample)))
