"""Config-driven trainer and predictor: ``ctunet_tpu/trainer.py`` on one
CUDA card.

Parity target: the reference ``Model`` (``ctunet/pytorch/Model.py:24-562``)
and ``ctunet_tpu``'s port of it. ``Model(cfg_file)`` or
``Model(params=dict)`` parses the config over ``default_params``, resolves
the workspace, binds the problem handler and the datasets, then trains
and/or tests according to the flags. CLI: ``ctunet-tpu-torch <cfg.ini>`` /
``python -m ctunet_tpu_torch <cfg.ini>``.

- ``train_flag``: epochs of train steps (``steps.py``: on-device synthesis,
  atlas stack, forward/backward in the compute dtype, the optimizer) and
  eval steps, TensorBoard scalars under ``{phase}/epoch/{key}``, the
  best-model / periodic-checkpoint / ini-snapshot rules of the reference
  (``Model.py:266-296``), a checkpoint on SIGTERM/SIGINT, and resume of
  parameters, BatchNorm statistics, optimizer state and step from a
  ``s_resume_model`` written by this package. Every ported model trains:
  the generic family with the double-output handlers, the legacy k=5
  family (``recAE_v2_fixed``, ``UNet4_2IC``) with the single-output ones
  (``FlapRec``, ``FlapRecWithShapePrior``, ``DenoisingAE``); a model whose
  output count is not the handler's is refused before any step.
  ``conv_impl`` picks how the convs run (``models/unet.py``,
  ``models/legacy.py``): ``chain`` and ``pallas`` the hand-written k=3 conv
  kernel forward and dgrad, ``pallas`` the k=5 one (K5) on the legacy
  family, ``xla`` a library conv (and ``chain`` at k=5, as in JAX).
  ``b_packed_train`` and ``b_remat`` are TPU memory-layout choices of the
  JAX package: they are accepted and the same dense graph runs.
  ``b_fg_crop_train`` trains and evaluates on a static foreground window
  (``s_fg_train_size``, or planned over every train and validation
  volume), cut per sample on the device (``steps.make_fg_crop_fn``).
  ``s_param_dtype`` (``float32``, ``bfloat16`` or ``float16``) is the
  dtype the parameters are held, trained, saved and loaded in, BatchNorm's
  aside (f32, as in the JAX package); ``s_profile_dir`` writes a
  ``torch.profiler`` trace of the first epoch's train pass there, each
  step a ``record_function`` span.
- ``test_flag``: every test volume through the engine in
  ``compute_dtype`` (``engine.py``: bf16 or f32 on the card), or with
  ``use_int8`` the calibrated int8 engine (``engine_q.py``), whole or,
  with ``b_fg_crop``, on its foreground window (``i_fg_margin``) pasted
  back into the canvas; ``i_serve_scan`` K groups K volumes per
  ``predict`` call, ``b_serve_profile`` prints where the loop waits; with
  ``b_patch_inference`` the sliding window (``ops/sliding_window.py``:
  ``i_patch_size`` patches at ``f_patch_overlap``, ``i_patch_batch`` per
  engine call, Gaussian blending in f32) runs the engine per patch, one
  volume at a time and never on a crop, as in ``ctunet_tpu``;
  writing ``pred_<name>/<file>_{sk,fl,i}`` NIfTI files
  (``<file>_{fl,i}`` for the single-output handlers ``FlapRec`` and
  ``FlapRecWithShapePrior``). The legacy k=5 models (``recAE_v2_fixed``,
  ``UNet4_2IC``) are served by the float engine in every case: they have
  no int8 path, as in ``ctunet_tpu``.

It runs on the CUDA card: ``s_device`` ``tpu``, ``gpu``, ``cuda`` or unset
all mean the card, and a missing card is an error. ``device = cpu`` runs
the same code with the kernels' plain PyTorch versions (what the tests
do).

Multi-device (``parallel/``): one process per device. With
``b_distributed`` each process is one rank of a ``torch.distributed``
group, brought up before any device query; ``i_mesh_data`` x
``i_mesh_spatial`` must be the world size (``i_mesh_data = 0``: the world
over ``i_mesh_spatial``). ``i_batch_size`` stays the global batch: each
data rank loads and steps on its slice, with the global batch's BatchNorm
statistics, averaged gradients and terms (``steps.DataShard``), so the run
equals the single-process one. Ranks that differ only in their spatial
coordinate do the same work, as the JAX ``Model`` shards only the batch.
Rank 0 initialises (or loads) the parameters and broadcasts them, writes
the TensorBoard events, checkpoints and INI snapshot while the others
wait, and alone runs ``test()``. One process with ``i_mesh_data`` or
``i_mesh_spatial`` above 1 raises ``ValueError``: launch that many
processes.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import contextlib
import itertools
import os
import signal
import sys
import time
from shutil import copyfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import checkpoint as ckpt
from . import engine
from . import problem as _problem  # noqa: F401  (registers handlers)
from . import registry, steps
from .data import atlas as atlas_mod
from .data.pipeline import HostLoader, device_prefetch, upload
from .device import resolve_device
from .models import MODEL_INPUT_CHANNELS, build_model, parse_param_dtype
from .models.unet import sync_batch_stats
from .ops import foreground
from .parallel import distributed as dist_rt
from .parallel import make_mesh
from .utils import (default_params, makedir, model_summary,
                    print_params_dict, set_cfg_params, tic, toc_eps)
from .utils import profiling
from .utils.misc import FLOP_PROBE
from .utils.tb_writer import make_writer

# the serving loop's span; its stages are the spans directly inside it
# (``ctunet.serve.<stage>``, and ``ctunet.upload``), read by serve_profile
SERVE_SPAN = "ctunet.serve"
SERVE_STAGES = ("decode_wait", "pad", "upload", "dispatch", "wait", "fetch",
                "write_drain")


def _np_corners(offs, sizes):
    """The 8 corner coordinates of a crop box (canvas coordinates)."""
    return [tuple(o if lo else o + s - 1
                  for o, s, lo in zip(offs, sizes, bits))
            for bits in itertools.product((True, False), repeat=len(offs))]


def paste_window(mask: np.ndarray, images: np.ndarray, offsets,
                 full_shape) -> np.ndarray:
    """A window's ``(1, d, h, w)`` mask pasted at ``offsets`` into the
    ``full_shape`` canvas (``ctunet_tpu/trainer.py:1224-1242``). The fill
    is the class the window holds at its first corner whose voxel of the
    unpadded input ``images`` ``(1, D, H, W)`` is 0 (the margin leaves one
    unless the box touches the canvas edge on every axis); 0 if none."""
    bg = 0
    for corner in _np_corners(offsets, mask.shape[-3:]):
        probe = tuple(min(c, s - 1) for c, s in zip(corner, images.shape[1:]))
        if images[(0,) + probe] == 0:
            bg = int(mask[(0,) + tuple(c - o for c, o in zip(corner,
                                                             offsets))])
            break
    return foreground.paste_full(mask, offsets, full_shape, bg)


def int8_calib_hint(volume: np.ndarray, multiple: int, atlas=None,
                    crop_offsets=None, fg_margin: int = 16):
    """The AdaQuant calibration window of one served volume
    (``ctunet_tpu/trainer.py:1270-1298``): ``volume`` ``(d, h, w)``, the
    padded volume or its crop at ``crop_offsets`` on the canvas, planned
    at margin ``min(16, fg_margin)`` and the model's pool ``multiple``,
    stacked with the padded ``atlas`` at the same canvas offsets.
    ``(1, d', h', w', C)`` f32 on the host, or None when the plan gains
    nothing."""
    plan16 = foreground.plan_crop(volume, margin=min(16, fg_margin),
                                  multiple=multiple)
    if plan16 is None:
        return None
    chans = [volume[foreground.crop_slices(*plan16)]]
    if atlas is not None:
        g_offs = (plan16[0] if crop_offsets is None else
                  tuple(o + p for o, p in zip(crop_offsets, plan16[0])))
        chans.append(np.asarray(atlas)[foreground.crop_slices(g_offs,
                                                              plan16[1])])
    return np.stack(chans, -1).astype(np.float32)[None]


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class _ScalarWriter:
    """TensorBoard scalar writer + in-memory history
    (``utils/tb_writer.py``: no tensorboard package needed)."""

    def __init__(self, logdir: Optional[str]):
        self.history: Dict[str, list] = {}
        self._tb = make_writer(logdir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self.history.setdefault(tag, []).append((step, float(value)))
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()


class Model:
    """Config-driven train/test entry point (ref ``Model.py:24-145``)."""

    def __init__(self, cfg_file=None, params: Optional[Dict] = None):
        if cfg_file and params:
            params = None
            print("You provided both a cfg file and a params dictionary. "
                  "Only the cfg file will be used")
        if cfg_file is None and params is None:
            print("No configuration file provided.")
        # the CLI passes argv as a list (ref ``Model.py:44``)
        cfg_file = cfg_file[0] if isinstance(cfg_file, list) else cfg_file
        if cfg_file and not os.path.exists(cfg_file):
            raise FileNotFoundError(
                f"The configuration file does not exists ({cfg_file}).")

        self.params = default_params()
        if params is not None:
            self.params.update(params)
        if not params:
            parsed = set_cfg_params(cfg_file, self.params)
            if parsed is not None:
                self.params = parsed
        self.cfg_path = cfg_file
        self.resolve_out_folder()

        # the ranks first, before any device query
        # (ctunet_tpu/trainer.py:124-133), then their mesh
        self.process_index, self.process_count = \
            dist_rt.initialize_from_params(self.params)
        self.mesh = self._make_mesh()
        name = self.params.get("compute_dtype") or "bfloat16"
        if name not in _DTYPES:
            raise ValueError(
                f"compute_dtype {name!r}: one of {list(_DTYPES)}")
        self.compute_dtype = _DTYPES[name]
        # the dtype the parameters are held, trained and saved in
        # (ctunet_tpu/trainer.py:331); BatchNorm's stay f32
        self.param_dtype = parse_param_dtype(self.params.get("param_dtype"))
        self.device = dist_rt.rank_device(
            resolve_device(self.params.get("device")))
        # spatial divisibility of the model: 32 for the 5-block family
        self.pool_multiple = engine.pool_multiple(self.params["model_class"])

        self.problem_handler = registry.get_problem(
            self.params["problem_handler"])()
        if self.params.get("train_flag") is True:
            self._check_outputs()
        self.write_predictions = self.problem_handler.write_predictions
        self.models: Dict = {"main": None}
        self.state_dict: Optional[Dict[str, torch.Tensor]] = None
        self.state: Optional[steps.TrainState] = None
        self.data: Dict = {"train_loader": None, "validation_loader": None,
                           "test_loader": None}
        self.load_datasets()
        self.current_epoch = 0
        self.best_model = {"epoch": 1, "value": None}
        self.losses_and_metrics: Dict[str, list] = {}
        self.step_losses: list = []  # per-batch train losses, last epoch
        self.fg_train_size = None  # the b_fg_crop_train window, when used
        self.train_seconds = 0.0
        self._atlas = None
        self._from_pairs = False
        seed = int(self.params.get("seed") or 0)
        # the stream of the synthesis draws (hole, noise, crops)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # rank 0 writes the events; every rank keeps the history (the
        # scalars are the global batch's, the same on every rank)
        self.writer = _ScalarWriter(
            self.params.get("tensorboard_run_path")
            if self.params.get("train_flag") and self.process_index == 0
            else None)
        self.out_paths = None
        self.n_served = 0
        self.serve_seconds = 0.0
        self.int8_build_seconds = 0.0  # part of serve_seconds
        self.int8_engines: Dict = {}  # shape -> int8 predict, None = bf16
        # input shape -> shape of the window AdaQuant searched on (None: the
        # whole calibration input)
        self.int8_hint_shapes: Dict = {}
        # patch serving: the central patch the int8 engine calibrated on
        self.int8_calib_patch = None
        self._calib_hint = None  # -> the last dispatched volume's window
        self.scan_batches: list = []  # volumes per K-batch predict call
        self.serve_profile_s: Dict[str, float] = {}  # b_serve_profile

        if self.params.get("train_flag") is True:
            self.train()
        if self.params.get("test_flag") is True:
            self.test()

    def _make_mesh(self):
        """The ``(i_mesh_data, i_mesh_spatial)`` mesh over the ranks; one
        process per device, so a single process serves a 1x1 mesh only."""
        data = int(self.params.get("mesh_data") or 0)
        spatial = int(self.params.get("mesh_spatial") or 1)
        if self.process_count == 1 and max(data, spatial) > 1:
            raise ValueError(
                f"i_mesh_data = {data}, i_mesh_spatial = {spatial} in one "
                "process: ctunet_tpu_torch runs one process per device, so "
                f"launch {max(data, 1) * spatial} processes with "
                "b_distributed (README, Multi-device)")
        return make_mesh(data, spatial)

    def _shard(self):
        """This rank's :class:`steps.DataShard`, None with one data rank."""
        m = self.mesh
        if m.data == 1:
            return None
        return steps.DataShard(m.data_group, m.data, m.data_index)

    def _check_outputs(self) -> None:
        """A model trains only with a handler whose targets it returns:
        outputs and classes, two 2-class heads for the double-output
        handlers, one 2-class softmax head for the single-output ones (the
        head-less generic models return one 3-channel map)."""
        mc, hd = self.params["model_class"], self.params["problem_handler"]
        cfg = engine.ENGINE_CONFIGS.get(mc)
        if cfg is None:
            return  # an unknown family, refused when it is built
        model = {"double": (2, 2), "double_softmax": (2, 2),
                 "softmax": (1, 2)}.get(cfg["head"], (1, 3))
        handler = (2 if self.problem_handler.double_output else 1, 2)
        if model != handler:
            raise ValueError(
                f"model {mc} returns {model[0]} output(s) of {model[1]} "
                f"classes, problem handler {hd} takes {handler[0]} of "
                f"{handler[1]}: choose a matching pair")

    # ------------------------------------------------------------------
    # Paths / data
    # ------------------------------------------------------------------

    def resolve_out_folder(self) -> None:
        """Workspace layout (ref ``Model.py:407-446``):
        ``workspace/<ModelClass>_<Handler>/model/<name>.ckpt`` plus a
        ``runs/`` TensorBoard directory."""
        if not self.params.get("workspace_path"):
            raise AttributeError("workspace_path not defined in the ini file.")
        wsp = self.params["workspace_path"] = os.path.expanduser(
            self.params["workspace_path"])
        makedir(wsp)
        mc, hd = self.params["model_class"], self.params["problem_handler"]
        run_name = f"{mc}_{hd}"
        model_folder = makedir(os.path.join(wsp, run_name, "model"))

        name = self.params.get("name")
        res_path = self.params.get("resume_model") or ""
        res_filename = os.path.splitext(os.path.split(res_path)[1])[0]
        if name in ("", None) and res_path in ("", None):
            raise AttributeError(
                "You should set at least a name or a path of a previously "
                "trained model for lookup.")
        self.params["model_path"] = res_path if res_path != "" else None
        self.params["name"] = res_filename if not name and res_path else name
        if not self.params.get("force_resumed"):
            self.params["model_path"] = os.path.join(
                model_folder, self.params["name"] + ".ckpt")
        if self.params.get("tensorboard_run_path") is None:
            self.params["tensorboard_run_path"] = os.path.join(
                wsp, "runs", run_name + "_" + self.params["name"])

    def load_datasets(self) -> None:
        """Train, validation and test loaders (ref ``Model.load_datasets``,
        ``Model.py:189-224``): training samples with replacement (quirk
        Q4), the test loader runs in dataset order at batch 1. Each data
        rank loads its slice of the train and validation batches; the
        test loader is whole (``test`` runs on rank 0)."""
        p = self.params
        handler = self.problem_handler
        if p.get("train_flag"):
            for key, csv in (("train_loader", "train_files_csv"),
                             ("validation_loader", "validation_files_csv")):
                self.data[key] = HostLoader(
                    handler.train_dataset_class(p[csv]),
                    batch_size=p["batch_size"], shuffle=True,
                    replacement=True, n_workers=p.get("n_workers") or 2,
                    seed=int(p.get("seed") or 0),
                    process_id=self.mesh.data_index,
                    num_processes=self.mesh.data)
        if p.get("test_flag") and (p.get("test_files_csv")
                                   or p.get("single_file")):
            ds = handler.test_dataset_class(
                p.get("test_files_csv"), single_file=p.get("single_file"))
            self.data["test_loader"] = HostLoader(
                ds, batch_size=1, n_workers=p.get("n_workers") or 2)

    # ------------------------------------------------------------------
    # Weights
    # ------------------------------------------------------------------

    def _sample_shape(self):
        """(volume shape, whether samples are stored pairs) of the first
        available dataset, or ``(None, False)`` without one."""
        for key in ("train_loader", "test_loader", "validation_loader"):
            loader = self.data.get(key)
            if loader is not None:
                sample = loader.dataset[0]
                return tuple(sample["image"].shape), ("flap" in sample)
        return None, False

    def initialize_models(self, load_out: bool = False) -> None:
        """Build the model (random weights from ``seed``), load the atlas,
        then load weights: the workspace model when ``load_out`` (the test
        path), else ``resume_model`` when set
        (ref ``Model.initialize_models``, ``Model.py:493-508``)."""
        mc = self.params["model_class"]
        im_shape, self._from_pairs = self._sample_shape()
        if im_shape is not None and self.problem_handler.append_atlas:
            self._atlas = atlas_mod.load_atlas(
                im_shape, self.params.get("atlas_dir"))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(int(self.params.get("seed") or 0))
            model = build_model(mc, self.param_dtype)
        path = (self.params["model_path"] if load_out
                else self.params.get("resume_model") or None)
        if path:
            # strict: checks every key. A loaded tensor keeps its own dtype
            # in place of the initialised one, whatever param_dtype, as the
            # JAX trainer merges a loaded tree over the initialised one
            # (ctunet_tpu/trainer.py:452-457)
            loaded = self._load_variables(path)
            model.load_state_dict({k: v.detach().clone()
                                   for k, v in loaded.items()}, assign=True)
        self.state_dict = {k: v.detach().clone()
                           for k, v in model.state_dict().items()}
        self.models["main"] = model.eval()
        if self.params.get("show_model_summary"):
            # at the pool-multiple-padded input, as the JAX trainer
            # initialises and summarises its model
            shape = tuple(s + (-s % self.pool_multiple)
                          for s in (im_shape or FLOP_PROBE))
            n_ch = MODEL_INPUT_CHANNELS.get(
                mc, 2 if self.problem_handler.append_atlas else 1)
            model_summary(model, (1, *shape, n_ch))

    def _load_variables(self, path: str) -> Dict[str, torch.Tensor]:
        """Load a ``.npz`` flax export or a reference ``.pt`` state_dict,
        falling back to ``resume_model`` when the workspace model is missing
        (ref ``Model.load_model``, ``Model.py:448-472``)."""
        if (self.params.get("train_flag") is not True
                and self.params.get("test_flag") is True
                and (self.params.get("resume_model") or "") != ""
                and not os.path.exists(path)):
            path = self.params["resume_model"]
            print("using 'resume_model' trained model for predicting..")
        return ckpt.load_any(path)

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------

    def train(self) -> None:
        """Training loop (``trainer.py:485-582``, ref ``Model.train``,
        ``Model.py:226-264``)."""
        p = self.params
        self.initialize_models()
        model = self.models["main"].to(self.device).configure(
            p.get("conv_impl") or "xla", self.compute_dtype)
        shard = self._shard()
        if self.process_count > 1:  # rank 0's parameters everywhere
            self._broadcast(model)
        if shard is not None:
            sync_batch_stats(model, shard.group, shard.size)
        state = steps.TrainState(
            model, steps.make_optimizer(p, model.parameters()))
        resume = p.get("resume_model") or ""
        if ckpt.is_train_state(resume):
            restored = ckpt.restore_checkpoint(resume)
            state.optimizer.load_state_dict(restored["optimizer"])
            state.step = int(restored["step"])
            print(f"resumed optimizer state and step {state.step} from "
                  f"{resume}")
        self.state = state

        loss_cfg = {k: p.get(k)
                    for k in ("ce_lambda", "dice_lambda", "save_dice_plots")}
        tps = int(p.get("train_patch_size") or 0)
        train_patch = (tps, tps, tps) if tps > 0 else None
        common = dict(atlas=self._atlas, compute_dtype=self.compute_dtype,
                      from_pairs=self._from_pairs, train_patch=train_patch)
        fg_size = (None if train_patch is not None
                   else self._fg_train_size(self._sample_shape()[0]))
        if fg_size is not None:
            common.update(fg_crop_size=fg_size, fg_margin=self._fg_margin)
        self.fg_train_size = fg_size
        train_step = steps.make_train_step(model, self.problem_handler,
                                           loss_cfg, shard=shard, **common)
        eval_step = steps.make_eval_step(model, self.problem_handler,
                                         loss_cfg, shard=shard, **common)
        print_params_dict(p)

        # on SIGTERM/SIGINT: finish the current batch, checkpoint, and exit
        # cleanly so that `resume_model` continues from the interrupted state
        interrupted = {"flag": False}
        prev_handlers = {}

        def _on_signal(signum, frame):
            interrupted["flag"] = True
            print(f"signal {signum} received: checkpointing after the "
                  "current batch...")

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(sig, _on_signal)
            except ValueError:  # not the main thread
                pass
        self._interrupted = interrupted
        t0 = time.perf_counter()
        try:
            # debug_nans: autograd's anomaly detection for the training loop
            # (the reference's detect_anomaly; jax_debug_nans in the JAX
            # package, ctunet_tpu/trainer.py:184-185)
            with torch.autograd.set_detect_anomaly(bool(p.get("debug_nans"))):
                self._train_epochs(int(p["n_epochs"]), train_step, eval_step,
                                   interrupted)
        finally:
            self.train_seconds = time.perf_counter() - t0
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)
            self.writer.close()

    @staticmethod
    def _broadcast(model: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers into every rank's ``model``."""
        import torch.distributed as dist

        for t in model.state_dict().values():
            dist.broadcast(t, src=0)

    def _fg_train_size(self, im_shape):
        """The static foreground window of ``b_fg_crop_train``
        (``ctunet_tpu/trainer.py:356-423``): ``s_fg_train_size`` when set,
        else the elementwise max of the ``plan_crop`` sizes over every
        train and validation volume (image OR flap for pair datasets), at
        ``fg_margin`` and the model's pool multiple (32 for the 5-block
        family); None (train whole volumes) when cropping gains nothing."""
        p = self.params
        if not p.get("fg_crop_train"):
            return None
        margin = self._fg_margin = int(p.get("fg_margin") or 16)
        override = str(p.get("fg_train_size") or "").strip()
        if override:
            size = tuple(int(v) for v in
                         override.replace("x", ",").split(","))
            assert len(size) == 3, f"s_fg_train_size: {override!r}"
            mult = self.pool_multiple
            assert all(s % mult == 0 for s in size), (
                f"s_fg_train_size {size} must divide by {mult}")
            return size
        if self.data.get("train_loader") is None:
            return None
        sets = [self.data[k].dataset for k in ("train_loader",
                                               "validation_loader")
                if self.data.get(k) is not None]

        def fg_volumes():
            for ds in sets:
                for i in range(len(ds)):
                    sample = ds[i]
                    vol = np.asarray(sample["image"], np.float32)
                    if "flap" in sample:
                        vol = np.maximum(vol, np.asarray(sample["flap"],
                                                         np.float32))
                    yield vol

        size = steps.fg_crop_size_for(fg_volumes(), im_shape, margin=margin,
                                      multiple=self.pool_multiple)
        if size is None:
            print("fg_crop_train: no shrink on this dataset; training whole "
                  "volumes")
        else:
            print(f"fg_crop_train: {im_shape} -> {size} (scanned "
                  f"{sum(map(len, sets))} train+val volumes, margin {margin}, "
                  f"snap {self.pool_multiple})")
        return size

    def _profiled(self, profile_dir: str):
        """A ``torch.profiler`` trace (host and, on the card, CUDA
        activity, each hand-written kernel inside its wrapper's span)
        written into ``profile_dir`` when the block ends, as
        ``jax.profiler.trace`` does (``ctunet_tpu/trainer.py:591-597``):
        one ``<host>_<pid>.<ns>.pt.trace.json`` for TensorBoard or
        Perfetto. The window is ``utils/profiling.trace``'s, padded on the
        card so that it holds every kernel of the pass."""
        from torch.profiler import tensorboard_trace_handler

        handler = tensorboard_trace_handler(os.path.expanduser(profile_dir))
        return profiling.trace(self.device, on_trace_ready=handler)

    def _train_epochs(self, n_epochs, train_step, eval_step,
                      interrupted) -> None:
        profile_dir = self.params.get("profile_dir") or ""
        for n_epoch in range(1, n_epochs + 1):
            ep_time = tic()
            self.current_epoch = n_epoch
            print("Epoch: ", n_epoch)
            if profile_dir and n_epoch == 1:
                # the first epoch's train pass only, as in the JAX package
                with self._profiled(profile_dir):
                    self._forward_pass_train(train_step, n_epoch)
            else:
                self._forward_pass_train(train_step, n_epoch)
            self.update_plots_tensorboard_avg("train", n_epoch)
            self._forward_pass_eval(eval_step, n_epoch)
            ep_loss_v = self.update_plots_tensorboard_avg("val", n_epoch)

            if n_epoch == 1 or (ep_loss_v is not None and (
                    self.best_model["value"] is None
                    or ep_loss_v < self.best_model["value"])):
                if self.best_model["value"] is not None:
                    print("New best model found. Overwriting saved model. "
                          f"(new best val loss: {ep_loss_v:.5f} vs "
                          f"{self.best_model['value']:.5f})")
                self.best_model["value"] = ep_loss_v
                self.best_model["epoch"] = n_epoch
            toc_eps(ep_time, n_epoch, n_epochs)

            autosave = int(self.params.get("autosave_epochs") or 0)
            if autosave and (n_epoch % autosave) == 0:
                self.save_main_model(self.cfg_path, True)
                if self.params.get("test_flag"):
                    self.test()
            self.save_main_model()
            if self.process_count > 1:  # a signal to one rank stops all
                import torch.distributed as dist

                flag = torch.tensor([int(interrupted["flag"])],
                                    device=self.device)
                dist.all_reduce(flag, op=dist.ReduceOp.MAX)
                interrupted["flag"] = bool(flag.item())
            if interrupted["flag"]:
                print(f"interrupted at epoch {n_epoch}: emergency checkpoint "
                      "saved; resume with s_resume_model.")
                self.save_main_model(self.cfg_path, True)
                break

    def _accumulate(self, terms: Dict[str, Any]):
        """Collect the per-batch scalars without waiting for the device:
        they stay tensors until the epoch average (or a console line)
        reads them."""
        for k, v in terms.items():
            self.losses_and_metrics.setdefault(k, []).append(v)
        return terms["epoch_loss"]

    def _device_batches(self, loader, depth: int = 2):
        for batch in device_prefetch(iter(loader), self.device, depth=depth):
            yield {k: v for k, v in batch.items() if not isinstance(v, list)}

    def _forward_pass_train(self, train_step, n_epoch: int) -> None:
        print("Phase: train.")
        loader = self.data["train_loader"]
        log_every = int(self.params.get("log_every") or 0)
        n = len(loader)
        depth = int(self.params.get("prefetch_depth") or 2)
        self.step_losses = []
        for idx, batch in enumerate(self._device_batches(loader, depth)):
            # a span per step: a profiler trace shows the step boundaries
            with torch.profiler.record_function(
                    f"epoch {n_epoch} train step {idx}"):
                self.state, terms = train_step(self.state, batch, self._gen)
            loss = self._accumulate(terms)
            self.step_losses.append(loss)
            if log_every and (idx + 1) % log_every == 0:
                print("    Batch {}/{} ({:.0f}%)\tLoss: {:.6f}".format(
                    idx + 1, n, 100.0 * (idx + 1) / n, float(loss)))
            if self._interrupted["flag"] and self.process_count == 1:
                break  # finish the epoch's bookkeeping, then checkpoint

    def _forward_pass_eval(self, eval_step, n_epoch: int) -> None:
        print("Phase: val.")
        want_hd = bool(self.params.get("save_hd_plots"))
        if want_hd and self.mesh.data > 1:
            # as the JAX trainer (ctunet_tpu/trainer.py:699-707): the host
            # Hausdorff needs the whole batch's label maps on one host
            print("  note: save_hd_plots skipped with several data ranks")
            want_hd = False
        for idx, batch in enumerate(
                self._device_batches(self.data["validation_loader"])):
            with torch.profiler.record_function(
                    f"epoch {n_epoch} eval step {idx}"):
                terms, (out, targets) = eval_step(self.state, batch,
                                                  self._gen)
            self._accumulate(terms)
            if want_hd:
                hm = self.problem_handler.host_metrics(out, targets,
                                                       self.params)
                for k, v in hm.items():
                    self.losses_and_metrics.setdefault(k, []).append(float(v))

    def update_plots_tensorboard_avg(self, phase: str, i: int,
                                     type: str = "epoch",
                                     print_to_console: bool = False
                                     ) -> Optional[float]:
        """Average and log the accumulated scalars
        (ref ``Model.py:382-405``); returns the mean epoch loss."""
        ep_loss = None
        vals = [float(v) for v in self.losses_and_metrics.get("epoch_loss", [])]
        if vals:
            ep_loss = float(np.mean(vals))
        for key, vals in self.losses_and_metrics.items():
            if not vals:
                continue
            avg = sum(float(v) for v in vals) / len(vals)
            self.writer.add_scalar(f"{phase}/{type}/{key}", float(avg), i)
            self.losses_and_metrics[key] = []
            if print_to_console:
                print(f"{type} {i} average: {float(avg)}.")
        return ep_loss

    # ------------------------------------------------------------------
    # Checkpointing
    # ------------------------------------------------------------------

    def save_main_model(self, cfg_file=None, save_checkpoint=False) -> None:
        """Best-model overwrite + periodic checkpoints + ini snapshot
        (ref ``Model.save_main_model``, ``Model.py:266-296``). Several
        ranks: rank 0 writes while the others wait (every rank holds the
        same state)."""
        if self.process_index == 0:
            self._save(cfg_file, save_checkpoint)
        dist_rt.barrier_wait(f"save epoch {self.current_epoch}")

    def _save(self, cfg_file, save_checkpoint) -> None:
        path = self.params["model_path"]
        dir_m, fname = os.path.split(path)
        makedir(dir_m)
        if self.current_epoch == self.best_model["epoch"]:
            ckpt.save_checkpoint(path, self.state, extra={
                "epoch": self.current_epoch,
                "model_class": self.params["model_class"]})
        if cfg_file and self.current_epoch == 1:
            copyfile(cfg_file, path.replace(".ckpt", "_params.ini"))
        if save_checkpoint:
            dir_chk = makedir(os.path.join(dir_m, "checkpoints"))
            chk_p = os.path.join(dir_chk, fname.replace(
                ".ckpt", f"_ep{self.current_epoch}.ckpt"))
            ckpt.save_checkpoint(chk_p, self.state,
                                 extra={"epoch": self.current_epoch})
            print("Checkpoint saved ({})".format(save_checkpoint))
        print("Model saved ({})".format(path))

    # ------------------------------------------------------------------
    # Inference
    # ------------------------------------------------------------------

    def test(self) -> None:
        """Prediction pass (ref ``Model.test``, ``Model.py:298-322``): on
        the weights just trained, else on the workspace model (or
        ``resume_model`` when that is missing). Several ranks: rank 0 alone
        serves every test volume (``ctunet_tpu/trainer.py:787-795``)."""
        if self.process_index != 0:
            return
        if self.models["main"] is None:
            self.initialize_models(load_out=True)
        if self.state is not None:  # serve the weights as trained so far
            self.state_dict = {
                k: v.detach().cpu().clone()
                for k, v in self.state.model.state_dict().items()}
        if (not self.params.get("test_files_csv")
                and not self.params.get("single_file")):
            print("No csv provided for testing")
            return
        if not self.params.get("single_file"):
            print("Images to test: ",
                  os.path.split(self.params["test_files_csv"] or "")[0])
            print_params_dict(self.params)
        self._forward_pass_test()

    def _make_whole_volume_predict(self, atlas=None):
        """``predict(images, offsets=None)`` on ``(B, D, H, W)`` device
        volumes (``ctunet_tpu/trainer.py:851-1001``): stacks the atlas
        channel on the device in ``compute_dtype`` and runs the engine in
        that dtype (or, with ``use_engine = False``, the plain model in
        ``compute_dtype``, as ``ctunet_tpu``'s ``steps.make_predict_fn``
        serves ``model.apply``). Images smaller than the padded ``atlas``
        are foreground crops: image ``i``'s atlas channel is the atlas
        sliced at ``offsets[i]``, its window's offsets on the canvas. With
        ``use_int8`` the int8 engine serves instead, built lazily on the
        first volume of each input shape (the crop window's in crop
        serving)."""
        dtype = self.compute_dtype
        fwd = self._float_forward()
        use_q = bool(self.params.get("use_int8")) and self.params.get(
            "use_engine", True)
        q_by_shape = self.int8_engines
        # the atlas is a serving-time constant: upload it once
        atlas_dev = (None if atlas is None
                     else upload(np.asarray(atlas, np.float32), self.device,
                                 dtype))

        def predict(images: torch.Tensor, offsets=None):
            chans = [images.to(dtype)]
            if atlas_dev is not None:
                win = tuple(images.shape[1:])
                if win == tuple(atlas_dev.shape):
                    chans.append(atlas_dev.expand(images.shape))
                else:
                    chans.append(torch.stack([
                        atlas_dev[foreground.crop_slices(o, win)]
                        for o in offsets]))
            x = torch.stack(chans, -1)
            if not use_q:
                return fwd(x)
            shape = tuple(x.shape[1:])
            if shape not in q_by_shape:
                q_by_shape[shape] = self._build_int8(x[0])
            qfn = q_by_shape[shape]
            return fwd(x) if qfn is None else qfn(x)

        return predict

    def _float_forward(self):
        """The float forward of the serving paths on ``(B, D, H, W, C)``:
        the engine in ``compute_dtype``, or with ``use_engine = False`` the
        plain model in ``compute_dtype``, as ``ctunet_tpu``'s
        ``steps.make_predict_fn`` serves ``model.apply``."""
        dtype = self.compute_dtype
        if self.params.get("use_engine", True):
            return engine.build_predict(self.params["model_class"],
                                        self.state_dict, dtype, self.device)
        # a copy: the trained model keeps its train settings
        model = build_model(self.params["model_class"], self.param_dtype)
        model.load_state_dict(self.state_dict)
        return model.to(self.device).eval().configure("xla", dtype)

    def _make_patch_predict(self, atlas=None):
        """``predict(images, offsets=None)`` on ``(B, D, H, W)`` device
        volumes by sliding windows (``ctunet_tpu/trainer.py:1006-1120``):
        ``patch_size`` cubes at ``patch_overlap``, ``patch_batch`` per
        forward call, each through the float engine. With ``use_int8``
        the per-patch engine is the int8 one (AdaQuant first when
        ``int8_adaquant``), built on the first volume served and kept for
        every volume: calibrated on that volume's central patch, the
        padded ``atlas`` at the same offsets, both rounded to
        ``compute_dtype`` (``:1030-1037``), with AdaQuant's search on that
        patch too. Only ``engine_q.Unsupported`` falls back to the float
        engine."""
        from .ops.sliding_window import make_sliding_window_fn

        p = self.params
        ps = int(p.get("patch_size") or 128)
        fwd = self._float_forward()
        use_q = bool(p.get("use_int8")) and p.get("use_engine", True)
        sw = {}

        def build(vol: torch.Tensor):
            apply_fn = fwd
            if use_q:
                dt = self.compute_dtype
                ctr = [max(0, (s - ps) // 2) for s in vol.shape]
                box = tuple(slice(c, c + ps) for c in ctr)
                chans = [vol[box].to(dt)]
                if atlas is not None:
                    chans.append(torch.as_tensor(
                        np.asarray(atlas)[box], dtype=torch.float32).to(
                            vol.device, dt))
                calib = torch.stack(chans, -1)
                self.int8_calib_patch = calib
                qfn = self._build_int8(calib)
                self.int8_engines[tuple(calib.shape)] = qfn
                if qfn is not None:
                    apply_fn = qfn
            return make_sliding_window_fn(
                apply_fn, patch_size=ps,
                overlap=float(p.get("patch_overlap") or 0.5), atlas=atlas,
                compute_dtype=self.compute_dtype,
                patch_batch=int(p.get("patch_batch") or 1))

        def predict(images: torch.Tensor, offsets=None):
            if "fn" not in sw:
                sw["fn"] = build(images[0])
            return sw["fn"](images)

        return predict

    def _build_int8(self, x0: torch.Tensor):
        """The int8 engine calibrated on ``x0`` ``(D, H, W, C)``: AdaQuant
        first (``int8_adaquant``), then plain int8. AdaQuant's rounding
        search runs on the calibration window of the volume just
        dispatched (:func:`int8_calib_hint`) when it has fewer voxels than
        ``x0``, in whole-volume and crop serving alike
        (``ctunet_tpu/trainer.py:915-929``), or on ``x0`` itself when no
        window was set (patch serving); the scales calibrate on ``x0``.
        Only ``engine_q.Unsupported``, raised while planning before any
        launch, moves on to the next mode; ``None`` means the float engine
        serves (in ``compute_dtype``).
        A failing kernel build or launch is never caught here."""
        from . import engine_q

        p = self.params
        common = dict(
            compute_dtype=self.compute_dtype, device=self.device,
            calib_quantile=float(p.get("int8_calib_quantile") or 1.0),
            bf16_tail=float(p.get("int8_bf16_tail") or 0),
            bf16_head=float(p.get("int8_bf16_head") or 0))
        builders = [("int8", engine_q.build_predict_q, {})]
        if p.get("int8_adaquant"):
            hint = self._calib_hint() if self._calib_hint else None
            extra = dict(adaquant_steps=int(p.get("int8_adaquant_steps")
                                            or 250),
                         learn_scales=bool(p.get("int8_learn_scales")))
            if hint is not None and hint[0].size < x0.numel():
                extra["calib_batch"] = hint
            self.int8_hint_shapes[tuple(x0.shape)] = (
                tuple(hint.shape[1:]) if "calib_batch" in extra else None)
            builders.insert(0, ("int8+adaquant", engine_q.build_predict_q_opt,
                                extra))
        t0 = time.perf_counter()
        for label, builder, extra in builders:
            # the serving loop runs under inference_mode; AdaQuant needs
            # autograd, and an inference tensor cannot be saved for backward
            with torch.inference_mode(False), torch.enable_grad():
                calib = x0.clone()
                try:
                    qfn = builder(p["model_class"], self.state_dict, calib,
                                  **common, **extra)
                except engine_q.Unsupported as e:
                    print(f"{label} engine unavailable ({e}); trying the "
                          "next serving mode.")
                    continue
            self.int8_build_seconds += time.perf_counter() - t0
            batch = extra.get("calib_batch")
            print(f"serving: calibrated {label} engine for "
                  f"{tuple(x0.shape)} in {time.perf_counter() - t0:.1f} s"
                  + ("" if batch is None else
                     f" (rounding searched on {tuple(batch.shape[1:])})"))
            return qfn
        print("serving the float engine.")
        return None

    def _forward_pass_test(self) -> None:
        """Serve every test volume (``ctunet_tpu/trainer.py:1120-1441``):
        pad to the pool multiple; with ``fg_crop`` plan the foreground
        window (``fg_margin``) and serve only it; upload through pinned
        memory, run the engine, take the argmax on the device, paste the
        window's masks back into the canvas on the host, and write them
        on a small thread pool while the next volumes are in flight
        (``prefetch_depth``). With ``serve_scan`` K > 1, groups of K
        volumes of one canvas share a running-max window and all but a
        new window's first volume go through one ``predict`` call.
        The loop runs inside the span ``ctunet.serve``, each stage inside
        one of its own (:data:`SERVE_STAGES`); ``serve_profile`` records
        them (``utils/profiling.recording``) and prints what they took
        (:meth:`_print_serve_profile`)."""
        print("Phase: test.")
        p = self.params
        if p.get("largest_cc"):
            from .ops.postprocess import largest_cc

            self.problem_handler.postprocess = largest_cc
        mult = self.pool_multiple
        atlas_p = self._atlas
        if atlas_p is not None:
            apads = [(0, -s % mult) for s in np.shape(atlas_p)]
            if any(a[1] for a in apads):
                atlas_p = np.pad(np.asarray(atlas_p), apads)
        # patch serving takes whole volumes one at a time: no crop (as in
        # ctunet_tpu) and no K-batch (a window blends within one volume)
        patch_on = bool(p.get("patch_inference"))
        predict = (self._make_patch_predict(atlas_p) if patch_on
                   else self._make_whole_volume_predict(atlas_p))
        fg_on = bool(p.get("fg_crop")) and not patch_on
        fg_margin = int(p.get("fg_margin") or 16)
        serve_scan = 1 if patch_on else max(1, int(p.get("serve_scan") or 1))
        depth = max(1, int(p.get("prefetch_depth") or 2))
        pending: collections.deque = collections.deque()
        write_futs = []
        prof_on = bool(p.get("serve_profile"))
        scan_static: Dict = {}  # canvas -> running window size
        warmed: set = set()
        cuda = self.device.type == "cuda"
        span = profiling.span

        def hardify(out):
            # argmax on the device: only uint8 masks cross the link
            return tuple(torch.argmax(o, -1).to(torch.uint8)
                         for o in (out if isinstance(out, tuple) else (out,)))

        def unpad(m, images, crop_info):
            a = m.cpu().numpy()
            if crop_info is not None:
                a = paste_window(a, images, *crop_info)
            return a[(slice(None),) + tuple(slice(0, s)
                                            for s in images.shape[1:])]

        def flush_one(pool):
            masks, batch, crop_info = pending.popleft()
            images = batch["image"]
            if cuda:  # the work queued on the stream, apart from the copy
                with span("ctunet.serve.wait"):
                    torch.cuda.current_stream(self.device).synchronize()
            with span("ctunet.serve.fetch"):
                host = tuple(unpad(m, images, crop_info) for m in masks)
            write_futs.append(pool.submit(
                self.write_predictions, host if len(host) > 1 else host[0],
                batch["filepath"], p["name"], images))

        def enqueue(masks, batch, crop_info, pool):
            pending.append((masks, batch, crop_info))
            self.n_served += batch["image"].shape[0]
            if len(pending) >= depth:
                flush_one(pool)

        def dispatch_one(batch, cropped, crop_info, pool):
            """Upload one ``(1, d, h, w)`` volume, dispatch, enqueue."""
            vol, offs = cropped[0], None if crop_info is None else crop_info[0]
            # the AdaQuant window of this volume, built only if a build
            # needs it (ctunet_tpu/trainer.py:1270-1298)
            if not patch_on:
                self._calib_hint = lambda: int8_calib_hint(
                    vol, mult, atlas_p, offs, fg_margin)
            up = upload(cropped, self.device, torch.float32)
            with span("ctunet.serve.dispatch"):
                out = hardify(predict(up, None if offs is None else [offs]))
            enqueue(out, batch, crop_info, pool)

        def dispatch_single(batch, padded, plan, pool):
            crop_info = None
            if plan is not None:
                offs, sizes = plan
                crop_info = (offs, padded.shape[1:])
                padded = np.ascontiguousarray(
                    padded[(slice(None),) + foreground.crop_slices(offs,
                                                                   sizes)])
            dispatch_one(batch, padded, crop_info, pool)

        def dispatch_group(group, pool):
            """K volumes of one canvas share a pool-aligned window, the
            running max of their planned sizes; each is cut at its own
            offsets, clamped into the canvas (the window start only moves
            down, so each box stays covered). A new window is warmed by
            one single dispatch (its int8 engine builds there); the rest
            go as one stacked upload and one ``predict`` call
            (``ctunet_tpu/trainer.py:1331-1398``)."""
            items, group[:] = list(group), []
            if not items:
                return
            canvas = items[0][1].shape
            if len(items) == 1 or any(it[1].shape != canvas for it in items):
                for it in items:
                    dispatch_single(*it, pool)
                return
            canvas_sp = canvas[1:]
            size = canvas_sp
            if fg_on and all(it[2] is not None for it in items):
                need = (max(it[2][1][ax] for it in items) for ax in range(3))
                cur = scan_static.get(canvas_sp, (0, 0, 0))
                size = tuple(min(c, s + (-s % mult)) for c, s in zip(
                    canvas_sp, (max(n, q) for n, q in zip(need, cur))))
                scan_static[canvas_sp] = size
            if size == canvas_sp:
                offs_k = [(0, 0, 0)] * len(items)
                crop_infos = [None] * len(items)
                vols = [it[1][0] for it in items]
            else:
                offs_k = [tuple(min(o, c - s) for o, c, s in
                                zip(it[2][0], canvas_sp, size))
                          for it in items]
                crop_infos = [(o, canvas_sp) for o in offs_k]
                vols = [it[1][0][foreground.crop_slices(o, size)]
                        for it, o in zip(items, offs_k)]
            if size not in warmed:
                warmed.add(size)
                dispatch_one(items.pop(0)[0], np.ascontiguousarray(
                    vols.pop(0)[None]), crop_infos.pop(0), pool)
                offs_k.pop(0)
                if not items:
                    return
            stacked = np.stack(vols)  # contiguous, one pinned upload
            up = upload(stacked, self.device, torch.float32)
            with span("ctunet.serve.dispatch"):
                outs = hardify(predict(up, offs_k))
            self.scan_batches.append(len(items))
            for k, (batch, _, _) in enumerate(items):
                enqueue(tuple(o[k:k + 1] for o in outs), batch,
                        crop_infos[k], pool)

        n_batches = 0
        group: list = []
        before = profiling.snapshot() if prof_on else None
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            if prof_on:
                stack.enter_context(profiling.recording())
            stack.enter_context(span(SERVE_SPAN))
            stack.enter_context(torch.inference_mode())
            pool = stack.enter_context(cf.ThreadPoolExecutor(2))
            it = iter(self.data["test_loader"])
            while True:
                with span("ctunet.serve.decode_wait"):
                    batch = next(it, None)
                if batch is None:
                    break
                n_batches += 1
                images = batch["image"]
                pads = [(0, -s % mult) for s in images.shape[1:]]
                with span("ctunet.serve.pad"):
                    padded = np.pad(images, [(0, 0)] + pads)
                plan = None
                if fg_on and padded.shape[0] == 1:
                    plan = foreground.plan_crop(padded[0], margin=fg_margin,
                                                multiple=mult)
                if serve_scan > 1 and padded.shape[0] == 1:
                    group.append((batch, padded, plan))
                    if len(group) >= serve_scan:
                        dispatch_group(group, pool)
                else:
                    dispatch_single(batch, padded, plan, pool)
            dispatch_group(group, pool)
            while pending:
                flush_one(pool)
            with span("ctunet.serve.write_drain"):
                for f in write_futs:
                    self.out_paths = f.result()
        self.serve_seconds = time.perf_counter() - t0
        self._calib_hint = None  # let the last volume go
        if prof_on and n_batches:
            self._print_serve_profile(before, profiling.snapshot(),
                                      n_batches)

    def _print_serve_profile(self, before, after, n_batches: int) -> None:
        """Keep in ``serve_profile_s`` and print the seconds the serving
        loop spent in each of :data:`SERVE_STAGES`: the host time of the
        spans directly inside ``ctunet.serve`` that the loop added to the
        recorder between the snapshots ``before`` and ``after``; ``wait``
        the wait for the work queued on the device's stream before the
        masks' copy (with ``prefetch_depth`` 2 the next volume's engine
        too; 0 on the CPU), ``fetch`` the copy and the unpadding, ``other``
        the rest of ``serve_seconds``. Then the upload's counters."""
        was = profiling.children_ms(before, SERVE_SPAN)
        prof = dict.fromkeys(SERVE_STAGES, 0.0)
        for name, ms in profiling.children_ms(after, SERVE_SPAN).items():
            stage = name.rsplit(".", 1)[-1]
            prof[stage] = prof.get(stage, 0.0) + (ms - was.get(name, 0.0)
                                                  ) / 1e3
        prof["other"] = self.serve_seconds - sum(prof.values())
        self.serve_profile_s = prof
        print("serving profile (loop-blocking seconds, "
              f"{n_batches} batches, {self.serve_seconds:.2f}s total):")
        for k, v in sorted(prof.items(),
                           key=lambda kv: (kv[0] == "other", -kv[1])):
            print(f"  {k:<14s} {v:8.2f}s  ({v / n_batches * 1000:7.1f} "
                  "ms/batch)")
        counters = {k: v - before["counters"].get(k, 0)
                    for k, v in after["counters"].items()
                    if k.startswith("ctunet.upload.")}
        print("  " + ", ".join(f"{k} {v}" for k, v in sorted(
            counters.items())))


def load_ini_file(ini_file: str) -> None:
    """Create a Model from an INI path (``trainer.load_ini_file``, ref
    ``Model.py:549-551``)."""
    Model(ini_file)


def cli() -> None:
    """Console entry point: ``ctunet-tpu-torch <cfg.ini>``."""
    if len(sys.argv) > 1:
        Model([sys.argv[1]])
