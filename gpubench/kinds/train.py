"""The training loop: ``mix["volumes"]`` distinct complete skulls go round
at the configuration's batch through ``data.pipeline.device_prefetch`` into
``steps.make_train_step``, with the model, problem handler, optimizer and
synthesis generator that ``Model.train`` builds; steps run back to back.
Set-up drives the same step object through ``mix["checked"]`` steps
first, on distinct skulls, and keeps what they produced for the
comparison.

It follows whole-volume training on one process from weights drawn from
the seed, and refuses a configuration that sets a training path it does
not follow (patches, the foreground window, a resumed state, several
ranks). Its pairs are synthesized from complete skulls, as ``Model.train``
makes them where the dataset holds no flaps.

Mix parameters: ``volumes``, ``checked`` (steps compared with the
reference), ``warmup`` (further steps in set-up), ``trace_units`` (steps in
a traced window).
"""

from __future__ import annotations

import itertools
import statistics
import time
from typing import Dict, Optional

import numpy as np
import torch

from gpubench import inputs, systems
from gpubench.reference import train as ref_train
from gpubench.reference import unet as ref_unet

# training settings of the package that this loop does not follow, with
# the value it follows
UNFOLLOWED = {"train_patch_size": 0, "fg_crop_train": False,
              "resume_model": "", "dist_coordinator": ""}


class System:
    """The training loop (module docstring)."""

    def __init__(self, cfg: Dict, mix: Dict, seed: int, device,
                 canvas) -> None:
        self.cfg, self.mix, self.device = cfg, mix, device
        self.canvas = tuple(canvas)
        self.setup_stages = stages = systems.Stages()
        p = systems.program_params(cfg, device, "")
        systems.refuse(p, UNFOLLOWED)
        self.params = p
        with stages("build"):
            if (p.get("conv_impl") or "xla") != "xla":
                # under xla the step launches library kernels only
                systems.build_kernels(device)
        with stages("model"):
            from ctunet_tpu_torch import problem  # noqa: F401 (handlers)
            from ctunet_tpu_torch import registry, steps
            from ctunet_tpu_torch.checkpoint import unflatten
            from ctunet_tpu_torch.data.pipeline import device_prefetch
            from ctunet_tpu_torch.models import (build_model,
                                                 parse_param_dtype)
            from ctunet_tpu_torch.models.convert import from_flax

            spec = cfg["model"]
            dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
            compute_dtype = dtypes[p["compute_dtype"]]
            self.weights = inputs.init_weights(
                spec, inputs.subseed(seed, 1), device)
            tree = unflatten({k: v.cpu().numpy()
                              for k, v in self.weights.items()})
            model = build_model(p["model_class"],
                                parse_param_dtype(p["param_dtype"]))
            model.load_state_dict(from_flax(tree["params"],
                                            tree["batch_stats"]))
            model = model.to(device).configure(p.get("conv_impl") or "xla",
                                               compute_dtype)
            self.state = steps.TrainState(
                model, steps.make_optimizer(p, model.parameters()))
            handler = registry.get_problem(p["problem_handler"])()
        with stages("inputs"):
            self.atlas = inputs.atlas(self.canvas, device)
            self.volumes = inputs.skulls(self.canvas, mix["volumes"], seed,
                                         device, broken=False)
        loss_cfg = {k: p.get(k)
                    for k in ("ce_lambda", "dice_lambda", "save_dice_plots")}
        self.step = steps.make_train_step(
            model, handler, loss_cfg, atlas=self.atlas,
            compute_dtype=compute_dtype, from_pairs=False, train_patch=None)
        self.synth_seed = inputs.subseed(seed, 2)
        self.gen = torch.Generator(device=device).manual_seed(
            self.synth_seed)
        batch = int(p["batch_size"] or 1)
        n = len(self.volumes)

        def batches():
            for i in itertools.count(0, batch):
                yield {"image": np.concatenate(
                    [self.volumes[(i + b) % n] for b in range(batch)])}

        self.batch = batch
        self.feed = device_prefetch(batches(), device,
                                    int(p.get("prefetch_depth") or 2))
        # the checked steps, through the window's own call and feed
        with stages("checked"):
            named = dict(model.named_parameters())
            before, stats_before = self._flat_state({})
            self.losses = []
            self.grads = None
            b1 = self.state.optimizer.param_groups[0]["b1"]
            for i in range(int(mix["checked"])):
                self._one()
                self.losses.append(self._last_loss)
                if i == 0:  # the gradient as the optimizer took it: its
                    # first moment after one step (none held: none taken)
                    opt = self.state.optimizer
                    self.grads = self._flat_state({
                        k: opt.state[v]["mu"] / (1.0 - b1)
                        if "mu" in opt.state.get(v, {})
                        else torch.zeros_like(v)
                        for k, v in named.items()})[0]
            after, stats_after = self._flat_state({})
            self.losses = [float(v) for v in self.losses]
            self.change = {k: after[k] - before[k] for k in after}
            self.stats_change = {k: stats_after[k] - stats_before[k]
                                 for k in stats_after}
        with stages("warmup"):
            for _ in range(int(mix["warmup"])):
                self._one()
            systems.sync(device)

    def _flat_state(self, values: Dict[str, torch.Tensor]):
        """``(parameters, BatchNorm running statistics)`` of the model (or
        ``values`` in place of parameters) by their flax names, as f32 on
        the host."""
        from ctunet_tpu_torch.models.convert import to_flax

        sd = {k: v.detach().float().cpu()
              for k, v in self.state.model.state_dict().items()}
        sd.update({k: v.detach().float().cpu() for k, v in values.items()})
        params, stats = to_flax(sd, root=None)
        return systems.flat(params), systems.flat(stats)

    def _one(self) -> None:
        with systems.span("gpubench.upload"):
            batch = next(self.feed)
        with systems.span("gpubench.step"):
            self.state, terms = self.step(self.state, batch, self.gen)
        self._last_loss = terms["epoch_loss"]

    def window(self, seconds: Optional[float] = None,
               count: Optional[int] = None) -> Dict:
        """Train steps back to back for ``seconds`` (or ``count`` steps);
        the window ends in a synchronize."""
        systems.sync(self.device)
        n = 0
        t0 = time.perf_counter()
        while (time.perf_counter() - t0 < seconds if count is None
               else n < count):
            self._one()
            n += 1
        systems.sync(self.device)
        length = time.perf_counter() - t0
        return dict(attempted=n, completed=n, window_s=length,
                    train_step_ms=1e3 * length / n)

    def release(self) -> None:
        del self.step, self.state, self.feed
        systems.release_memory()

    def readings(self):
        """What the checked steps produced: ``(losses, first gradient,
        change over the steps, change of the running statistics)``, the
        last three by leaf."""
        return self.losses, self.grads, self.change, self.stats_change

    def reference_readings(self, q=None):
        """The reference's steps on the same weights, skulls, atlas and
        synthesis draws, in f32 (``q``: its operand rounding, a control),
        as :meth:`readings`."""
        spec, dev = self.cfg["model"], self.device
        if self.batch != 1:
            raise NotImplementedError("the reference steps at batch 1")
        p, s = ref_unet.split_weights({k: v.clone()
                                       for k, v in self.weights.items()})
        p0 = {k: v.clone() for k, v in p.items()}
        s0 = {k: v.clone() for k, v in s.items()}
        gen = torch.Generator(device=dev).manual_seed(self.synth_seed)
        vols = [torch.as_tensor(self.volumes[i % len(self.volumes)][0],
                                device=dev)
                for i in range(len(self.losses))]
        with systems.reference_precision():
            losses, grads = ref_train.run_steps(
                p, torch.as_tensor(self.atlas, device=dev), vols, gen,
                spec["n_blocks"], spec["head"],
                float(self.params["learning_rate"]), stats=s,
                **({} if q is None else {"q": q}))
        return (losses, {k: v.cpu().numpy() for k, v in grads.items()},
                {k: (p[k] - p0[k]).cpu().numpy() for k in p},
                {k: (s[k] - s0[k]).cpu().numpy() for k in s})

    def check(self) -> Dict[str, float]:
        """The checked steps against the reference's (:func:`compare`)."""
        return compare(self.readings(), self.reference_readings())


def compare(prog, ref) -> Dict[str, float]:
    """``loss_gap``, the largest relative gap of a step's loss;
    ``grad_gap`` and ``change_gap``, by the worst leaf, the gap between
    the norms of the first gradient and of the parameters' change over the
    steps, against the reference's norm of that leaf or of the median
    leaf, whichever is larger; ``stats_gap``, the same of the running
    statistics' change. Leaves whose reference gradient is under a
    thousandth of the median leaf's are left out of the first two.
    Readings as :meth:`System.readings`."""
    (lp, gp, dp, sp), (lr, gr, dr, sr) = prog, ref
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(lp, lr))
    g_ref = {k: float(np.linalg.norm(v)) for k, v in gr.items()}
    d_ref = {k: float(np.linalg.norm(v)) for k, v in dr.items()}
    s_ref = {k: float(np.linalg.norm(v)) for k, v in sr.items()}
    median = statistics.median(g_ref.values())
    live = [k for k, v in g_ref.items() if v >= 1e-3 * median]
    d_median = statistics.median(d_ref[k] for k in live)

    def gaps(prog_leaves, ref_norms, floor, names):
        return {k: abs(float(np.linalg.norm(prog_leaves[k])) - ref_norms[k])
                / max(ref_norms[k], floor) for k in names}

    g, d = gaps(gp, g_ref, median, live), gaps(dp, d_ref, d_median, live)
    s = gaps(sp, s_ref, statistics.median(s_ref.values()), list(s_ref))
    return dict(loss_gap=loss_gap, grad_gap=max(g.values()),
                change_gap=max(d.values()),
                grad_gap_median=statistics.median(g.values()),
                change_gap_median=statistics.median(d.values()),
                stats_gap=max(s.values()),
                worst_grad_leaf=max(g, key=g.get),
                worst_change_leaf=max(d, key=d.get),
                worst_stats_leaf=max(s, key=s.get),
                left_out=float(len(g_ref) - len(live)))
