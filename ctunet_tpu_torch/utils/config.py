"""INI config system with type-prefixed keys.

Reimplements the reference's config convention (``ctunet/utilities.py:215-256``
in vfmatzkin/ct-unet): keys in ``.ini`` files carry a two-character type
prefix — ``i_`` (int), ``f_`` (float), ``b_`` (bool), ``s_`` (string); any
other key is read as a string. Sections are cosmetic. Parsed values are merged
over a defaults dict so configs only need to name what they change.

The defaults dict mirrors the reference trainer's defaults
(``ctunet/pytorch/Model.py:50-87``) plus the knobs ``ctunet_tpu`` added
(mesh shape, dtype policy, patch inference). This is the PyTorch port's own
copy of ``ctunet_tpu/utils/config.py`` with the same keys and defaults, so
one INI gives the same params dict in both packages. Keys whose feature the
port does not serve yet raise ``NotImplementedError`` where they are read
(``trainer.py``), never here.
"""

from __future__ import annotations

import configparser
import os
from typing import Any, Dict, Optional


def default_params() -> Dict[str, Any]:
    """Fresh copy of the full default parameter dict.

    Keys marked [ref] mirror ``Model.py:50-87``; keys marked [tpu] are new.
    """
    return {
        # DEFAULT [ref]
        "train_flag": False,
        "test_flag": False,
        # MODEL [ref]
        "name": None,
        "model_class": None,
        "problem_handler": None,
        # TRAINING [ref]
        "device": None,
        "n_epochs": None,
        "batch_size": None,
        "dice_lambda": None,
        "ce_lambda": None,
        "acnn_path": None,
        "acnn_lambda": None,
        "msel_lambda": None,
        # OPTIMIZER [ref]
        "optimizer": None,
        "learning_rate": None,
        "momentum": None,
        "weight_decay": None,
        # PATHS [ref]
        "single_file": None,
        "workspace_path": None,
        "train_files_csv": None,
        "validation_files_csv": None,
        "test_files_csv": None,
        "tensorboard_run_path": None,
        # MISC [ref]
        "autosave_epochs": None,
        "save_dice_plots": None,
        "save_hd_plots": False,       # dynamic key in the reference
        "scheduler": None,            # dynamic key in the reference
        "resume_model": "",
        "show_model_summary": None,   # param table + FLOPs at model init
                                      # (the ref's consumer is commented
                                      # out, Model.py:354-358; live here)
        "n_workers": None,
        "force_resumed": False,
        # TPU-NATIVE EXTENSIONS [tpu]
        "atlas_dir": "~/headctools/assets/atlas/reg",  # ref hardcodes this
        "compute_dtype": "bfloat16",  # forward/backward compute precision
        "param_dtype": "float32",
        "seed": 0,
        "mesh_data": 0,               # 0 = the ranks over mesh_spatial
        "mesh_spatial": 1,
        "patch_inference": False,     # sliding-window patch inference
        "patch_size": 128,
        "patch_overlap": 0.5,         # 0.25 = 3x fewer patches at 512-res
        "patch_batch": 4,             # patches per scan step (batched
                                      # forwards; exact — see
                                      # ops/sliding_window.py)
        "use_engine": True,           # fused Pallas inference engine
        "fg_crop": False,             # [tpu] serve the foreground bbox +
                                      # margin instead of the whole canvas
                                      # (ops/foreground.py; mask pasted
                                      # back on host, parity measured by
                                      # parity_check --crop)
        "fg_margin": 24,              # [tpu] crop margin (voxels/side).
                                      # Measured sweep (PARITY.json
                                      # dice_*_crop_*_mN, round 5):
                                      # margin 16 costs 1.3pt flap Dice
                                      # (bf16 0.981) from the receptive-
                                      # field band at the crop border;
                                      # 24 restores 0.994 at the same
                                      # pipelined ms/vol; 48 adds <0.1pt
                                      # for 1.3x the voxels
        "use_int8": False,            # calibrated int8 serving engine
                                      # (PTQ; calibrates on the first test
                                      # volume, falls back to bf16 engine)
        "int8_calib_quantile": 1.0,   # <1: clipped (quantile) calibration
        "int8_bf16_tail": 0,          # final decoder blocks served bf16
                                      # inside the int8 chain (0 = fully
                                      # int8, .5 = half block: last unit +
                                      # head). Measured FLAT on mask
                                      # parity (PARITY.json tail columns)
                                      # — adaquant is what recovers it
        "int8_bf16_head": 0,          # leading ENCODER blocks served bf16
                                      # (PTQ parity: the sensitivity sweep
                                      # pins the loss on the first block's
                                      # activation quantization; .5 = only
                                      # the block's first unit)
        "int8_adaquant": True,        # calibration-time weight-rounding
                                      # optimization (quant_opt): the one
                                      # measured lever that brings int8
                                      # flap-mask parity >= 0.99 at FULL
                                      # int8 speed (PARITY.json aq
                                      # columns); adds ~1 min to the
                                      # first int8 build per shape
        "int8_adaquant_steps": 250,   # Adam steps per conv unit
        "int8_learn_scales": False,   # with int8_adaquant: also refine
                                      # activation scales (LSQ-style)
                                      # and rebuild via import_scales
        "train_patch_size": 0,        # >0: random-crop patch training
        "fg_crop_train": False,       # [tpu] foreground-crop TRAINING:
                                      # train on the skull bbox + margin
                                      # at a static, pool-aligned size
                                      # computed from the data (or
                                      # s_fg_train_size). Loss/BN see
                                      # crop voxels only — opt-in
                                      # accelerator, convergence measured
                                      # in BASELINE.md
        "fg_train_size": "",          # [tpu] "D,H,W" override for the
                                      # fg_crop_train window (default:
                                      # computed from the dataset bboxes)
        "prefetch_depth": 2,          # host->device pipeline depth
        "serve_scan": 1,              # [tpu] >1: batch K test volumes
                                      # through ONE lax.scan dispatch
                                      # (amortizes the per-dispatch host
                                      # gap; with b_fg_crop the group
                                      # shares a static pool-aligned
                                      # window — per-volume offsets keep
                                      # the atlas registered). The bench
                                      # headline serving mode.
        "serve_profile": False,       # print per-stage serving-loop times
        "debug_nans": False,          # jax.debug_nans (ref: detect_anomaly)
        "profile_dir": "",            # torch.profiler trace of epoch 1
        "log_every": 1,               # console loss print frequency (batches)
        "remat": True,                # activation recomputation per block
        "drop_remainder": True,
        "largest_cc": False,          # postprocess: keep largest component
        "conv_impl": "xla",           # training conv: xla|xla_dw|pallas|chain
        "packed_train": False,        # packed-resident training graph
                                      # (models/packed_resident.py)
        # multi-process runtime, one process per device
        # (parallel/distributed.py; ref ceiling is single-host
        # nn.DataParallel, Model.py:481-486)
        "distributed": False,         # torch.distributed group at start
        "dist_coordinator": "",       # "host:port" of rank 0 (env
                                      # CTUNET_COORDINATOR overrides)
        "dist_num_processes": 0,      # world size (CTUNET_NUM_PROCESSES)
        "dist_process_id": -1,        # this rank (CTUNET_PROCESS_ID)
    }


_PREFIX_PARSERS = {
    "i_": lambda section, key: section.getint(key),
    "f_": lambda section, key: section.getfloat(key),
    "b_": lambda section, key: section.getboolean(key),
    "s_": lambda section, key: section.get(key),
}


def set_cfg_params(
    cfg_file: Optional[str] = None,
    default_dict: Optional[Dict[str, Any]] = None,
) -> Optional[Dict[str, Any]]:
    """Parse an INI file into a typed params dict merged over defaults.

    Matches the reference semantics (``utilities.py:215-256``): the first two
    characters of each key select the type; unprefixed keys are strings; later
    sections override earlier ones; defaults fill in everything not set.
    """
    if cfg_file is None:
        return None
    if not os.path.exists(cfg_file):
        raise FileNotFoundError(
            f"The provided cfg file does not exist ({cfg_file})."
        )

    out = dict(default_dict) if default_dict is not None else {}
    config = configparser.ConfigParser()
    config.read(cfg_file)

    for section_name in config.sections():
        section = config[section_name]
        for key, value in config.items(section_name):
            prefix = key[:2]
            parser = _PREFIX_PARSERS.get(prefix)
            if parser is not None:
                out[key[2:]] = parser(section, key)
            else:
                out[key] = value
    return out


# Public alias matching the reference package API (``ctunet/__init__.py:1``).
load_params = set_cfg_params


def print_params_dict(dic: Dict[str, Any]) -> None:
    """Print params in a table-like format (ref ``utilities.py:259-268``)."""
    print("{:<20} {:<30}".format("Parameter", "Value"))
    for key, v in dic.items():
        print("{:<15} {:<10}".format(key, str(v)))
