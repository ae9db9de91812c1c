"""Config-driven predictor: the test path of ``ctunet_tpu/trainer.py``.

Parity target: the reference ``Model`` (``ctunet/pytorch/Model.py:24-145,
298-380``) and ``ctunet_tpu``'s port of it. ``Model(cfg_file)`` or
``Model(params=dict)`` parses the config over ``default_params``, resolves
the workspace, binds the problem handler and the test dataset, loads the
weights and, with ``test_flag``, serves every test volume whole through the
bf16 engine (``engine.py``), or with ``use_int8`` the calibrated int8
engine (``engine_q.py``), and writes ``pred_<name>/<file>_{sk,fl,i}``
NIfTI files. CLI: ``ctunet-tpu-torch <cfg.ini>`` /
``python -m ctunet_tpu_torch <cfg.ini>``.

It runs on the CUDA card: ``s_device`` ``tpu``, ``gpu``, ``cuda`` or unset
all mean the card, and a missing card is an error. ``device = cpu`` runs
the same code with the kernels' plain PyTorch versions (what the tests
do). Settings this port does not serve yet raise ``NotImplementedError``
naming their ROADMAP item instead of serving something else.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from . import checkpoint as ckpt
from . import engine
from . import problem as _problem  # noqa: F401  (registers handlers)
from . import registry
from .data import atlas as atlas_mod
from .data.pipeline import HostLoader, upload
from .device import resolve_device
from .models import build_model
from .utils import default_params, makedir, print_params_dict, set_cfg_params

# Spatial divisibility of the ported (4-block) models: 2^n_pool_levels.
POOL_MULTIPLE = 16

# (params key, is-set test, where the feature stands) for settings that
# ctunet_tpu serves and this port does not yet.
_NOT_PORTED = (
    ("train_flag", lambda v: v is True,
     "training, ROADMAP Queue 1 items 12-15"),
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
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Model:
    """Config-driven test entry point (ref ``Model.py:24-145``)."""

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
        self.write_predictions = self.problem_handler.write_predictions
        self.models: Dict = {"main": None}
        self.state_dict: Optional[Dict[str, torch.Tensor]] = None
        self.data: Dict = {"test_loader": None}
        self.load_datasets()
        self._atlas = None
        self.out_paths = None
        self.n_served = 0
        self.serve_seconds = 0.0
        self.int8_build_seconds = 0.0  # part of serve_seconds
        self.int8_engines: Dict = {}  # shape -> int8 predict, None = bf16

        if self.params.get("test_flag") is True:
            self.test()

    # ------------------------------------------------------------------
    # Paths / data
    # ------------------------------------------------------------------

    def resolve_out_folder(self) -> None:
        """Workspace layout (ref ``Model.py:407-446``):
        ``workspace/<ModelClass>_<Handler>/model/<name>.ckpt``."""
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

    def load_datasets(self) -> None:
        """Test loader (ref ``Model.load_datasets``, ``Model.py:189-224``)."""
        p = self.params
        if p.get("test_flag") and (p.get("test_files_csv")
                                   or p.get("single_file")):
            ds = self.problem_handler.test_dataset_class(
                p.get("test_files_csv"), single_file=p.get("single_file"))
            self.data["test_loader"] = HostLoader(
                ds, batch_size=1, n_workers=p.get("n_workers") or 2)

    # ------------------------------------------------------------------
    # Weights
    # ------------------------------------------------------------------

    def initialize_models(self) -> None:
        """Build the model, load its weights, load the atlas
        (ref ``Model.initialize_models``, ``Model.py:493-508``)."""
        mc = self.params["model_class"]
        if mc in engine.NOT_PORTED:
            raise NotImplementedError(
                f"{mc} is not served by ctunet_tpu_torch yet "
                f"({engine.NOT_PORTED[mc]})")
        loader = self.data.get("test_loader")
        if loader is not None and self.problem_handler.append_atlas:
            im_shape = loader.dataset[0]["image"].shape
            self._atlas = atlas_mod.load_atlas(
                im_shape, self.params.get("atlas_dir"))
        self.state_dict = self._load_variables(self.params["model_path"])
        model = build_model(mc)
        model.load_state_dict(self.state_dict)  # strict: checks every key
        self.models["main"] = model.eval()
        if self.params.get("show_model_summary"):
            n = sum(p.numel() for p in model.parameters())
            print(f"Model summary: {mc}, {n:,d} trainable parameters")

    def _load_variables(self, path: str) -> Dict[str, torch.Tensor]:
        """Load a ``.npz`` flax export or a reference ``.pt`` state_dict,
        falling back to ``resume_model`` when the workspace model is missing
        (ref ``Model.load_model``, ``Model.py:448-472``)."""
        if (self.params.get("test_flag") is True
                and (self.params.get("resume_model") or "") != ""
                and not os.path.exists(path)):
            path = self.params["resume_model"]
            print("using 'resume_model' trained model for predicting..")
        return ckpt.load_any(path)

    # ------------------------------------------------------------------
    # Inference
    # ------------------------------------------------------------------

    def test(self) -> None:
        """Prediction pass (ref ``Model.test``, ``Model.py:298-322``)."""
        if self.models["main"] is None:
            self.initialize_models()
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
        atlas channel on the device and runs the bf16 engine (or, with
        ``use_engine = False``, the plain f32 model). With ``use_int8`` the
        int8 engine serves instead, built lazily on the first volume of
        each shape (``ctunet_tpu/trainer.py:857-999``)."""
        dtype = self.compute_dtype
        if self.params.get("use_engine", True):
            fwd = engine.build_predict(self.params["model_class"],
                                       self.state_dict, dtype, self.device)
        else:
            model = self.models["main"].to(self.device)
            fwd = lambda x: model(x.float())  # noqa: E731
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
