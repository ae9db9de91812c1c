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
  ``s_resume_model`` written by this package. ``conv_impl`` picks how the
  model's k=3 convs run (``models/unet.py``): ``chain`` (and ``pallas``)
  the hand-written conv kernel forward and dgrad, ``xla`` a library conv.
  ``b_packed_train`` and ``b_remat`` are TPU memory-layout choices of the
  JAX package: they are accepted and the same dense graph runs.
- ``test_flag``: every test volume whole through the bf16 engine
  (``engine.py``), or with ``use_int8`` the calibrated int8 engine
  (``engine_q.py``), writing ``pred_<name>/<file>_{sk,fl,i}`` NIfTI files
  (``<file>_{fl,i}`` for the single-output handlers ``FlapRec`` and
  ``FlapRecWithShapePrior``). The legacy k=5 models (``recAE_v2_fixed``,
  ``UNet4_2IC``) are served by the bf16 engine in every case: they have no
  int8 path, as in ``ctunet_tpu``.

It runs on the CUDA card: ``s_device`` ``tpu``, ``gpu``, ``cuda`` or unset
all mean the card, and a missing card is an error. ``device = cpu`` runs
the same code with the kernels' plain PyTorch versions (what the tests
do). Settings this port does not serve yet raise ``NotImplementedError``
naming their ROADMAP item instead of serving something else: among them
training the legacy family or a single-output handler.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
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
from .models import build_model
from .utils import (default_params, makedir, print_params_dict,
                    set_cfg_params, tic, toc_eps)
from .utils.tb_writer import make_writer

# Spatial divisibility of the ported (4-block) models: 2^n_pool_levels.
POOL_MULTIPLE = 16

# (params key, is-set test, where the feature stands) for settings that
# ctunet_tpu serves and this port does not yet.
_NOT_PORTED = (
    ("fg_crop_train", bool,
     "foreground-crop training, ROADMAP Queue 1 item 9"),
    ("profile_dir", bool,
     "profiler trace of the first epoch, ROADMAP Queue 1 item 19"),
    ("fg_crop", bool, "foreground-crop serving, ROADMAP Queue 1 item 9"),
    ("serve_scan", lambda v: int(v or 1) > 1,
     "K-volume batching, ROADMAP Queue 1 item 9"),
    ("patch_inference", bool,
     "sliding-window inference, ROADMAP Queue 1 item 10"),
    ("serve_profile", bool,
     "serving-stage profile, ROADMAP Queue 1 item 19"),
    ("distributed", bool, "multi-process runs, ROADMAP Queue 1 item 18"),
    ("mesh_spatial", lambda v: int(v or 1) > 1,
     "depth-sharded serving, ROADMAP Queue 1 item 18"),
    # parameters are held in float32 (ctunet_tpu/trainer.py:331), the
    # JAX package's default; another dtype is not served yet
    ("param_dtype", lambda v: (v or "float32") != "float32",
     "parameters held in another dtype than float32, ROADMAP Queue 1 "
     "item 20"),
)

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

        for key, is_set, where in _NOT_PORTED:
            if is_set(self.params.get(key)):
                raise NotImplementedError(
                    f"{key}={self.params.get(key)!r} is not served by "
                    f"ctunet_tpu_torch yet ({where})")
        name = self.params.get("compute_dtype") or "bfloat16"
        if name not in _DTYPES:
            raise ValueError(
                f"compute_dtype {name!r}: one of {list(_DTYPES)}")
        self.compute_dtype = _DTYPES[name]
        self.device = resolve_device(self.params.get("device"))

        self.problem_handler = registry.get_problem(
            self.params["problem_handler"])()
        if self.params.get("train_flag") is True:
            mc = self.params["model_class"]
            if engine.ENGINE_CONFIGS.get(mc, {}).get("family") == "legacy":
                raise NotImplementedError(
                    f"training {mc} (legacy k=5 family) is not ported yet: "
                    "the next slice, K5 forward/dgrad with conv_impl = "
                    "'pallas' (ROADMAP Queue 1 item 16)")
            if not self.problem_handler.double_output:
                raise NotImplementedError(
                    f"training with {self.params['problem_handler']} needs "
                    "ops/warp.py and the single-output synthesis (ROADMAP "
                    "Queue 1 item 13)")
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
        self.train_seconds = 0.0
        self._atlas = None
        self._from_pairs = False
        seed = int(self.params.get("seed") or 0)
        # the stream of the synthesis draws (hole, noise, crops)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.writer = _ScalarWriter(self.params.get("tensorboard_run_path")
                                    if self.params.get("train_flag") else None)
        self.out_paths = None
        self.n_served = 0
        self.serve_seconds = 0.0
        self.int8_build_seconds = 0.0  # part of serve_seconds
        self.int8_engines: Dict = {}  # shape -> int8 predict, None = bf16

        if self.params.get("train_flag") is True:
            self.train()
        if self.params.get("test_flag") is True:
            self.test()

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
        Q4), the test loader runs in dataset order at batch 1."""
        p = self.params
        handler = self.problem_handler
        if p.get("train_flag"):
            for key, csv in (("train_loader", "train_files_csv"),
                             ("validation_loader", "validation_files_csv")):
                self.data[key] = HostLoader(
                    handler.train_dataset_class(p[csv]),
                    batch_size=p["batch_size"], shuffle=True,
                    replacement=True, n_workers=p.get("n_workers") or 2,
                    seed=int(p.get("seed") or 0))
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
        if mc in engine.NOT_PORTED:
            raise NotImplementedError(
                f"{mc} is not served by ctunet_tpu_torch yet "
                f"({engine.NOT_PORTED[mc]})")
        im_shape, self._from_pairs = self._sample_shape()
        if im_shape is not None and self.problem_handler.append_atlas:
            self._atlas = atlas_mod.load_atlas(
                im_shape, self.params.get("atlas_dir"))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(int(self.params.get("seed") or 0))
            model = build_model(mc)
        if load_out:
            model.load_state_dict(  # strict: checks every key
                self._load_variables(self.params["model_path"]))
        elif self.params.get("resume_model") not in ("", None):
            model.load_state_dict(
                self._load_variables(self.params["resume_model"]))
        self.state_dict = {k: v.detach().clone()
                           for k, v in model.state_dict().items()}
        self.models["main"] = model.eval()
        if self.params.get("show_model_summary"):
            n = sum(p.numel() for p in model.parameters())
            print(f"Model summary: {mc}, {n:,d} trainable parameters")

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
        common = dict(atlas=self._atlas, compute_dtype=self.compute_dtype,
                      from_pairs=self._from_pairs,
                      train_patch=(tps, tps, tps) if tps > 0 else None)
        train_step = steps.make_train_step(model, self.problem_handler,
                                           loss_cfg, **common)
        eval_step = steps.make_eval_step(model, self.problem_handler,
                                         loss_cfg, **common)
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

    def _train_epochs(self, n_epochs, train_step, eval_step,
                      interrupted) -> None:
        for n_epoch in range(1, n_epochs + 1):
            ep_time = tic()
            self.current_epoch = n_epoch
            print("Epoch: ", n_epoch)
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
            self.state, terms = train_step(self.state, batch, self._gen)
            loss = self._accumulate(terms)
            self.step_losses.append(loss)
            if log_every and (idx + 1) % log_every == 0:
                print("    Batch {}/{} ({:.0f}%)\tLoss: {:.6f}".format(
                    idx + 1, n, 100.0 * (idx + 1) / n, float(loss)))
            if self._interrupted["flag"]:
                break  # finish the epoch's bookkeeping, then checkpoint

    def _forward_pass_eval(self, eval_step, n_epoch: int) -> None:
        print("Phase: val.")
        want_hd = bool(self.params.get("save_hd_plots"))
        for batch in self._device_batches(self.data["validation_loader"]):
            terms, (out, targets) = eval_step(self.state, batch, self._gen)
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
        (ref ``Model.save_main_model``, ``Model.py:266-296``)."""
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
        ``resume_model`` when that is missing)."""
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
        """``predict(images)`` on ``(B, D, H, W)`` device volumes: stacks the
        atlas channel on the device in ``compute_dtype`` and runs the bf16
        engine (or, with ``use_engine = False``, the plain model in
        ``compute_dtype``, as ``ctunet_tpu``'s ``steps.make_predict_fn``
        serves ``model.apply``, ``trainer.py:1001-1003``). With
        ``use_int8`` the int8 engine serves instead, built lazily on the
        first volume of each shape (``ctunet_tpu/trainer.py:857-999``)."""
        dtype = self.compute_dtype
        if self.params.get("use_engine", True):
            fwd = engine.build_predict(self.params["model_class"],
                                       self.state_dict, dtype, self.device)
        else:
            # a copy: the trained model keeps its train settings
            model = build_model(self.params["model_class"])
            model.load_state_dict(self.state_dict)
            fwd = model.to(self.device).eval().configure("xla", dtype)
        use_q = bool(self.params.get("use_int8")) and self.params.get(
            "use_engine", True)
        q_by_shape = self.int8_engines
        # the atlas is a serving-time constant: upload it once
        atlas_dev = (None if atlas is None
                     else upload(np.asarray(atlas, np.float32), self.device,
                                 dtype))

        def predict(images: torch.Tensor):
            chans = [images.to(dtype)]
            if atlas_dev is not None:
                chans.append(atlas_dev.expand(images.shape))
            x = torch.stack(chans, -1)
            if not use_q:
                return fwd(x)
            shape = tuple(x.shape[1:])
            if shape not in q_by_shape:
                q_by_shape[shape] = self._build_int8(x[0])
            qfn = q_by_shape[shape]
            return fwd(x) if qfn is None else qfn(x)

        return predict

    def _build_int8(self, x0: torch.Tensor):
        """The int8 engine calibrated on ``x0`` ``(D, H, W, C)``: AdaQuant
        first (``int8_adaquant``), then plain int8. Only
        ``engine_q.Unsupported``, raised while planning before any launch,
        moves on to the next mode; ``None`` means the bf16 engine serves.
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
            builders.insert(0, ("int8+adaquant", engine_q.build_predict_q_opt,
                                dict(adaquant_steps=int(
                                    p.get("int8_adaquant_steps") or 250),
                                     learn_scales=bool(
                                         p.get("int8_learn_scales")))))
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
            print(f"serving: calibrated {label} engine for "
                  f"{tuple(x0.shape)} in {time.perf_counter() - t0:.1f} s")
            return qfn
        print("serving the bf16 engine.")
        return None

    def _forward_pass_test(self) -> None:
        """Serve every test volume (``trainer.py:1120``): pad to the pool
        multiple, upload through pinned memory, run the engine, take the
        argmax on the device, and write the masks on a small thread pool
        while the next volumes are in flight (``prefetch_depth``)."""
        print("Phase: test.")
        if self.params.get("largest_cc"):
            from .ops.postprocess import largest_cc

            self.problem_handler.postprocess = largest_cc
        atlas_p = self._atlas
        if atlas_p is not None:
            apads = [(0, -s % POOL_MULTIPLE) for s in np.shape(atlas_p)]
            if any(p[1] for p in apads):
                atlas_p = np.pad(np.asarray(atlas_p), apads)
        predict = self._make_whole_volume_predict(atlas_p)

        depth = max(1, int(self.params.get("prefetch_depth") or 2))
        pending: collections.deque = collections.deque()
        write_futs = []

        def flush_one(pool):
            masks, batch = pending.popleft()
            images = batch["image"]
            sl = (slice(None),) + tuple(slice(0, s) for s in images.shape[1:])
            host = tuple(m.cpu().numpy()[sl] for m in masks)
            write_futs.append(pool.submit(
                self.write_predictions, host if len(host) > 1 else host[0],
                batch["filepath"], self.params["name"], images))

        t0 = time.perf_counter()
        with torch.inference_mode(), cf.ThreadPoolExecutor(2) as pool:
            for batch in self.data["test_loader"]:
                images = batch["image"]
                pads = [(0, -s % POOL_MULTIPLE) for s in images.shape[1:]]
                x = upload(np.pad(images, [(0, 0)] + pads), self.device,
                           torch.float32)
                out = predict(x)
                outs = out if isinstance(out, tuple) else (out,)
                # argmax on the device: only uint8 masks cross the link
                pending.append((tuple(torch.argmax(o, -1).to(torch.uint8)
                                      for o in outs), batch))
                self.n_served += images.shape[0]
                if len(pending) >= depth:
                    flush_one(pool)
            while pending:
                flush_one(pool)
            for f in write_futs:
                self.out_paths = f.result()
        self.serve_seconds = time.perf_counter() - t0


def cli() -> None:
    """Console entry point: ``ctunet-tpu-torch <cfg.ini>``."""
    if len(sys.argv) > 1:
        Model([sys.argv[1]])
