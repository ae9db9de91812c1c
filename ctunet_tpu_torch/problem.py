"""Problem handlers: dataset binding, on-device target synthesis, losses
and prediction writing.

Counterpart of ``ctunet_tpu/problem.py`` (reference
``ctunet/pytorch/ProblemHandler.py:21-359``) for the flap problems. A
handler names its train and test datasets, whether the atlas is stacked as
a second input channel, how a training pair is synthesized from a complete
skull (or taken from a stored (broken, flap) pair), how the losses
compose, and how predictions are written: uint8 masks in the input's
physical space, ``pred_<name>/<file>_{sk,fl}.nii.gz`` for the
double-output handlers and ``<file>_fl.nii.gz`` for the single-output ones
(``FlapRec``, ``FlapRecWithShapePrior``: the legacy k=5 models' test
path), plus the input copy ``<file>_i.nii.gz``. The single-output
handlers synthesize one one-hot target: ``FlapRec`` a hole and salt and
pepper, ``FlapRecWithShapePrior`` the full cranioplasty chain
(``ops/warp.py``), ``DenoisingAE`` noise only.

Quirk Q4 is kept: the cross entropy consumes the models' post-sigmoid
outputs as if they were logits, and UNetSPSmall's heads, already
softmaxed, are softmaxed again for the Dice terms, as ``ctunet_tpu``
reproduces them (``problem.py:20-21``).
"""

from __future__ import annotations

import os
import shutil

from typing import Any, Dict

import numpy as np
import torch

from . import registry
from .data import datasets as ds
from .ops import codecs, losses, synthesis
from .ops.warp import cranioplasty_transform
from .utils import makedir, nifti


def _hard_mask(pred: np.ndarray) -> np.ndarray:
    """Hard class mask: integer inputs are already hard (the serving loop
    takes the argmax on the device); float probabilities get an argmax over
    the trailing channel axis."""
    if np.issubdtype(pred.dtype, np.integer):
        return pred.astype(np.float32)
    return np.argmax(pred, axis=-1).astype(np.float32)


def _mask_u8(mask: np.ndarray) -> np.ndarray:
    """Masks are written as uint8 NIfTI (class ids < 256)."""
    return np.asarray(mask).astype(np.uint8)


def _copy_input(inp_path: str, out_path: str) -> None:
    """The ``_i`` companion is the input itself: copy the bytes when the
    formats match, else decode and re-encode."""
    if os.path.splitext(inp_path)[1] == os.path.splitext(out_path)[1]:
        shutil.copyfile(inp_path, out_path)
    else:
        nifti.write(out_path, nifti.read(inp_path))


def single_output_losses(prediction, target, cfg: Dict[str, Any]):
    """Single-output loss (``problem.py:103-123``, ref
    ``ProblemHandler.py:44-102``): CE against the argmax-decoded target and
    the Dice loss, each weighted and logged weighted. Returns
    ``(total, terms)``."""
    terms = {}
    total = 0.0
    ce_l = cfg.get("ce_lambda") or 0.0
    dice_l = cfg.get("dice_lambda") or 0.0
    if ce_l != 0:
        ce = ce_l * losses.softmax_cross_entropy(
            prediction, torch.argmax(target, -1))
        terms["ce"] = ce
        total = total + ce
    if dice_l != 0:
        dl = dice_l * losses.dice_loss(prediction, target)
        terms["dice_loss"] = dl
        total = total + dl
    if cfg.get("save_dice_plots"):
        terms["dice_coef"] = losses.dice_coeff(prediction, target)
    terms["epoch_loss"] = total
    return total, terms


@registry.register_problem("FlapRecWithShapePriorDoubleOut")
class FlapRecWithShapePriorDoubleOut:
    """Double-output flap reconstruction with shape prior
    (ref ``ProblemHandler.py:191-354``)."""

    train_dataset_class = ds.FlapRecWShapePrior2OTrainDataset
    test_dataset_class = ds.NiftiImageWithAtlasDataset
    append_atlas = True
    double_output = True
    #: optional mask postprocessor (largest connected component), installed
    #: by the trainer from the ``largest_cc`` config key
    postprocess = None

    def __init__(self, with_sp: bool = True):
        if not with_sp:  # FlapRecDoubleOut configuration
            self.train_dataset_class = ds.FlapRec2OTrainDataset
            self.test_dataset_class = ds.NiftiImageDataset
            self.append_atlas = False

    def _post(self, hard: np.ndarray) -> np.ndarray:
        return self.postprocess(hard) if self.postprocess else hard

    # ------------------------------------------------------------------
    # Synthesis on the device (train/val), one sample; the step loops
    # ------------------------------------------------------------------

    def synthesize(self, gen: torch.Generator, volume: torch.Tensor):
        """Complete skull ``(D, H, W)`` -> (net input volume, (one-hot full
        skull, one-hot flap)) (``problem.py:236-238``)."""
        broken, (full, flap) = synthesis.flap_rec_transform(gen, volume)
        return broken, (codecs.one_hot(full, 2), codecs.one_hot(flap, 2))

    def targets_from_pair(self, broken: torch.Tensor, flap: torch.Tensor):
        """Targets of a stored (broken, flap) pair (``problem.py:240-242``).
        """
        full = torch.clamp(broken + flap, 0.0, 1.0)
        return broken, (codecs.one_hot(full, 2), codecs.one_hot(flap, 2))

    # ------------------------------------------------------------------
    # Losses / metrics
    # ------------------------------------------------------------------

    @staticmethod
    def compute_losses(prediction, target, cfg: Dict[str, Any]):
        """Double-output loss (``problem.py:244-280``, ref
        ``ProblemHandler.py:214-309``): CE on both heads against the argmax
        targets, Dice on the softmaxed heads, and with ``save_dice_plots``
        the Dice coefficients. Returns ``(total, terms)``."""
        full_p, flap_p = prediction
        full_t, flap_t = target
        terms = {}
        total = 0.0
        ce_l = cfg.get("ce_lambda") or 0.0
        dice_l = cfg.get("dice_lambda") or 0.0
        if dice_l != 0 or cfg.get("save_dice_plots"):
            full_sm = torch.softmax(full_p, -1)
            flap_sm = torch.softmax(flap_p, -1)
        if ce_l != 0:
            ce_sk = ce_l * losses.softmax_cross_entropy(
                full_p, torch.argmax(full_t, -1))
            ce_fl = ce_l * losses.softmax_cross_entropy(
                flap_p, torch.argmax(flap_t, -1))
            terms["ce_sk"], terms["ce_fl"] = ce_sk, ce_fl
            total = total + ce_sk + ce_fl
        if dice_l != 0:
            dl_sk = dice_l * losses.dice_loss(full_sm, full_t)
            dl_fl = dice_l * losses.dice_loss(flap_sm, flap_t)
            terms["dice_loss_sk"], terms["dice_loss_fl"] = dl_sk, dl_fl
            total = total + dl_sk + dl_fl
        if cfg.get("save_dice_plots"):
            terms["dice_coef_sk"] = losses.dice_coeff(full_sm, full_t)
            terms["dice_coef_fl"] = losses.dice_coeff(flap_sm, flap_t)
        terms["epoch_loss"] = total
        return total, terms

    def host_metrics(self, prediction, target, cfg) -> Dict[str, float]:
        """Hausdorff distances (a display metric; exact EDT on the host,
        ``problem.py:282-297``)."""
        out = {}
        if cfg.get("save_hd_plots"):
            (full_p, flap_p), (full_t, flap_t) = prediction, target
            out["hd_coef_sk"] = losses.hausdorff_device_argmax(full_p, full_t)
            out["hd_coef_fl"] = losses.hausdorff_device_argmax(flap_p, flap_t)
        return out

    # ------------------------------------------------------------------
    # Prediction writing (host side)
    # ------------------------------------------------------------------

    def write_predictions(self, predictions, input_filepaths,
                          output_folder_name, input_imgs=None):
        """``<file>_sk`` + ``<file>_fl`` + input copy ``_i`` per sample
        (``problem.py:299-331``)."""
        print(" Saving prediction for...")
        encoded_full, encoded_flap = (np.asarray(p) for p in predictions)
        saved = []
        for pred_sk, pred_fl, inp_path in zip(
            encoded_full, encoded_flap, input_filepaths
        ):
            path, name = os.path.split(inp_path)
            print("  " + name + "..")
            out_folder = makedir(
                os.path.join(path, "pred_" + output_folder_name))
            src = nifti.read(inp_path, header_only=True)
            for pred, sfx in ((pred_sk, "sk"), (pred_fl, "fl")):
                hard = self._post(_hard_mask(pred))
                o_name = name.replace(".nii.gz", f"_{sfx}.nii.gz")
                out_path = os.path.join(out_folder, o_name)
                nifti.write(out_path, src.with_data(_mask_u8(hard)))
                saved.append(out_path)
            orig = os.path.join(out_folder,
                                name.replace(".nii.gz", "_i.nii.gz"))
            _copy_input(inp_path, orig)
            saved.append(orig)
        return saved


@registry.register_problem("FlapRecDoubleOut")
class FlapRecDoubleOut(FlapRecWithShapePriorDoubleOut):
    """Double output without shape prior
    (ref ``ProblemHandler.py:357-359``)."""

    def __init__(self):
        super().__init__(with_sp=False)


def _write_single_output(handler, predictions, input_filepaths,
                         output_folder_name):
    """Single-output writer (``ctunet_tpu/problem.py:129-170``, ref
    ``ProblemHandler.py:116-163``): per sample the argmax mask as
    ``pred_<name>/<file>_fl.nii.gz`` in the input's physical space, or one
    ``<file>_c{i}.nii.gz`` per sub-volume when a sample holds several; the
    input copy ``_i`` of the last sample of the call, as the JAX writer
    makes it (the serving loop calls once per volume)."""
    print(" Saving prediction for...")
    saved = []
    out_folder = name = last_inp = None
    for pred, inp_path in zip(np.asarray(predictions), input_filepaths):
        path, name = os.path.split(inp_path)
        print("  " + name + "..")
        out_folder = makedir(os.path.join(path, "pred_" + output_folder_name))
        src = nifti.read(inp_path, header_only=True)
        last_inp = inp_path
        hard = _hard_mask(pred)
        if hard.ndim > 3:  # several images: <file>_c{i}.nii.gz each
            for i, sub in enumerate(hard.reshape((-1,) + hard.shape[-3:])):
                out_path = os.path.join(
                    out_folder, name.replace(".nii.gz", f"_c{i}.nii.gz"))
                nifti.write(out_path,
                            src.with_data(_mask_u8(handler._post(sub))))
                saved.append(out_path)
            continue
        out_path = os.path.join(out_folder,
                                name.replace(".nii.gz", "_fl.nii.gz"))
        nifti.write(out_path, src.with_data(_mask_u8(handler._post(hard))))
        saved.append(out_path)
    if out_folder is not None:
        orig = os.path.join(out_folder, name.replace(".nii.gz", "_i.nii.gz"))
        _copy_input(last_inp, orig)
        saved.append(orig)
    return saved


@registry.register_problem("FlapRec")
class FlapRec:
    """Single-output flap reconstruction, broken skull in, flap out (ref
    ``ProblemHandler.py:166-173``; ``recAE_v2_fixed``'s handler in
    ``examples/autoimplant2020/UNet/AutoImplant2020_woShapePrior.ini``)."""

    train_dataset_class = ds.FlapRecTrainDataset
    test_dataset_class = ds.NiftiImageDataset
    append_atlas = False
    double_output = False
    postprocess = None

    def _post(self, hard: np.ndarray) -> np.ndarray:
        return self.postprocess(hard) if self.postprocess else hard

    def synthesize(self, gen: torch.Generator, volume: torch.Tensor):
        """Complete skull ``(D, H, W)`` -> (broken skull with noise,
        one-hot flap) (``problem.py:189-196``): a hole always, salt and
        pepper (density up to 0.05) with probability 0.5."""
        full = (volume > 0).float()
        broken, flap = synthesis.skull_random_hole(gen, full, p=1.0)
        broken = synthesis.salt_and_pepper(gen, broken, p=0.5,
                                           noise_density=0.05)
        return broken, codecs.one_hot(flap, 2)

    def targets_from_pair(self, broken: torch.Tensor, flap: torch.Tensor):
        raise NotImplementedError(
            f"{type(self).__name__} does not support pre-augmented pairs")

    @staticmethod
    def compute_losses(prediction, target, cfg: Dict[str, Any]):
        return single_output_losses(prediction, target, cfg)

    def host_metrics(self, prediction, target, cfg) -> Dict[str, float]:
        return {}

    def write_predictions(self, predictions, input_filepaths,
                          output_folder_name, input_imgs=None):
        return _write_single_output(self, predictions, input_filepaths,
                                    output_folder_name)


@registry.register_problem("FlapRecWithShapePrior")
class FlapRecWithShapePrior(FlapRec):
    """Single-output flap reconstruction with the atlas as a second input
    channel (ref ``ProblemHandler.py:176-188``; ``UNet4_2IC``'s handler in
    ``examples/autoimplant2020/UNetSP/AutoImplant2020_wShapePrior.ini``)."""

    train_dataset_class = ds.FlapRecWShapePriorTrainDataset
    test_dataset_class = ds.NiftiImageWithAtlasDataset
    append_atlas = True

    def synthesize(self, gen: torch.Generator, volume: torch.Tensor):
        """Complete skull -> (broken skull, one-hot flap) through the full
        cranioplasty chain (``problem.py:212-216``)."""
        broken, (_full, flap) = cranioplasty_transform(gen, volume)
        return broken, codecs.one_hot(flap, 2)


@registry.register_problem("DenoisingAE")
class DenoisingAE(FlapRec):
    """Denoising autoencoder (ref ``ProblemHandler.py:362-371``): salt and
    pepper noise in, the clean skull out (``problem.py:342-356``)."""

    train_dataset_class = ds.BinaryDenoisingAEDatasetv2
    test_dataset_class = ds.NiftiImageDataset

    def synthesize(self, gen: torch.Generator, volume: torch.Tensor):
        """Complete skull -> (noisy skull, one-hot skull): noise of density
        up to 0.3 with probability 0.8."""
        full = (volume > 0).float()
        noisy = synthesis.salt_and_pepper(gen, full, p=0.8,
                                          noise_density=0.3)
        return noisy, codecs.one_hot(full, 2)
