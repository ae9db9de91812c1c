"""The serving loop of the legacy k=5 family (``UNet4_2IC``,
``recAE_v2_fixed``): the closed loop of ``kinds/serve.py`` as it is
(upload, the predict ``Model`` builds, whose engine is
``engine.build_legacy_predict``, the argmax, the mask's fetch), held
against the legacy reference (``reference/legacy.py``) on the committed
``torch.save`` weights.

The legacy family has no int8 path (``Model`` serves it on the float
engine under ``use_int8``), so the loop refuses ``use_int8`` besides the
settings the serving loop refuses; a serving cell's int8 control would be
the program itself. Its control is the reference with float8 operands, as
a training cell's: set-up keeps the masks it served of each sampled
volume, and :meth:`System.readings`, :meth:`System.reference_readings`
and :func:`compare` are the training loop's interface that
``control.py`` drives for every kind but ``serve``.

Mix parameters: those of ``kinds/serve.py``. After the warm-up, set-up
serves one mask of each of ``sample`` distinct volumes and keeps them.
"""

from __future__ import annotations

import collections
import os
from typing import Dict, Optional

import numpy as np
import torch

from gpubench import systems
from gpubench.reference import legacy as ref_legacy

_serve = systems.kind("serve")
FLIP_GAP = _serve.FLIP_GAP


class _Tally:
    """The comparison of served masks with the reference's probabilities
    ``(D, H, W, 2)`` of their volumes: ``flip_share_worst``,
    ``flip_share`` and ``gap_max`` as ``kinds/serve.py``'s check, and
    ``bone_share_min`` / ``_max``, the least and most share of a compared
    volume's voxels that the reference puts in class 1."""

    def __init__(self) -> None:
        self.gap_max, self.flips, self.voxels, self.worst = 0.0, 0, 0, 0.0
        self.masks = 0
        self.bone = []

    def volume(self, ref: torch.Tensor) -> None:
        self.bone.append(float((ref[..., 1] > ref[..., 0]).float().mean()))

    def mask(self, ref: torch.Tensor, mask) -> None:
        """One served ``mask`` (``(D, H, W)``, or ``(1, D, H, W)`` as
        served): the gap by which the reference's output for the served
        class lies below its best, and the voxels where that gap passes
        ``FLIP_GAP``."""
        m = torch.as_tensor(mask, device=ref.device).long().reshape(
            ref.shape[:-1])[..., None]
        gap = ref.amax(-1) - torch.gather(ref, -1, m)[..., 0]
        n = int((gap > FLIP_GAP).sum())
        self.gap_max = max(self.gap_max, float(gap.max()))
        self.flips += n
        self.voxels += gap.numel()
        self.worst = max(self.worst, n / gap.numel())
        self.masks += 1

    def numbers(self) -> Dict[str, float]:
        return dict(flip_share_worst=self.worst,
                    flip_share=self.flips / max(self.voxels, 1),
                    gap_max=self.gap_max, compared=float(self.masks),
                    bone_share_min=min(self.bone, default=0.0),
                    bone_share_max=max(self.bone, default=0.0))


def compare(got: Dict[int, object], ref: Dict[int, torch.Tensor]
            ) -> Dict[str, float]:
    """Served answers ``got`` (by volume: a uint8 mask ``(D, H, W)``, or
    probabilities ``(D, H, W, 2)``, which are argmaxed) against the
    reference's probabilities ``ref`` of the same volumes (:class:`_Tally`).
    """
    tally = _Tally()
    for k, answer in sorted(got.items()):
        if isinstance(answer, torch.Tensor) and answer.ndim == ref[k].ndim:
            answer = torch.argmax(answer, -1)
        tally.volume(ref[k])
        tally.mask(ref[k], answer)
    return tally.numbers()


class System(_serve.System):
    """The serving loop (module docstring)."""

    def __init__(self, cfg: Dict, mix: Dict, seed: int, device,
                 canvas) -> None:
        systems.refuse(systems.program_params(cfg, device, ""),
                       {"use_int8": False})
        self.weights = os.path.join(systems.ROOT, cfg["weights"])
        if not os.path.isfile(self.weights):
            raise FileNotFoundError(f"no weights at {self.weights}")
        super().__init__(cfg, mix, seed, device, canvas)
        # one volume after another, so these are as many distinct volumes,
        # each kept whole in the sample (it holds ``mix["sample"]``)
        want = min(int(mix["sample"]), len(self.volumes))
        with self.setup_stages("warmup"), torch.inference_mode():
            for _ in range(want):
                self._dispatch()
                self._flush()
            systems.sync(device)
        # the masks served in set-up, by volume
        self.setup_masks: Dict[int, tuple] = dict(self.sample)
        self.seen, self.sample = 0, []
        self.stages.clear()

    def _reference(self, sd, k: int, q=None) -> torch.Tensor:
        """The reference's probabilities ``(D, H, W, 2)`` on volume ``k``
        and the atlas."""
        dev = self.device
        vol = torch.as_tensor(self.volumes[k][0], device=dev)
        x = torch.stack([vol, torch.as_tensor(self.atlas, device=dev)],
                        -1)[None]
        kw = {} if q is None else {"q": q}
        with systems.reference_precision(), torch.no_grad():
            return ref_legacy.forward(sd, x, **kw)[0]

    def check(self) -> Dict[str, float]:
        """The window's sampled masks against the reference's outputs on
        the same inputs (:class:`_Tally`, each served mask counted)."""
        sd = ref_legacy.load(self.weights, self.device)
        by_volume = collections.defaultdict(list)
        for k, host in self.sample:
            by_volume[k].append(host[0])
        tally = _Tally()
        for k, served in sorted(by_volume.items()):
            ref = self._reference(sd, k)
            tally.volume(ref)
            for mask in served:
                tally.mask(ref, mask)
            del ref
        return tally.numbers()

    def readings(self) -> Dict[int, np.ndarray]:
        """The mask served in set-up of each sampled volume."""
        return {k: masks[0] for k, masks in self.setup_masks.items()}

    def reference_readings(self, q: Optional[object] = None
                           ) -> Dict[int, torch.Tensor]:
        """The reference's probabilities on each sampled volume, in f32
        (``q``: its operand rounding, a control)."""
        sd = ref_legacy.load(self.weights, self.device)
        return {k: self._reference(sd, k, q) for k in sorted(
            self.setup_masks)}
