"""Problem handlers, serving side: dataset binding + prediction writing.

Counterpart of the test path of ``ctunet_tpu/problem.py`` (reference
``ctunet/pytorch/ProblemHandler.py:191-359``). A handler names its test
dataset, whether the atlas is stacked as a second input channel, and how
predictions are written: ``pred_<name>/<file>_{sk,fl}.nii.gz`` uint8 masks
in the input's physical space plus the input copy ``<file>_i.nii.gz``.
Target synthesis and losses (training) are not ported yet (ROADMAP Queue 1
items 12-14).
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from . import registry
from .data import datasets as ds
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


@registry.register_problem("FlapRecWithShapePriorDoubleOut")
class FlapRecWithShapePriorDoubleOut:
    """Double-output flap reconstruction with shape prior
    (ref ``ProblemHandler.py:191-354``)."""

    test_dataset_class = ds.NiftiImageWithAtlasDataset
    append_atlas = True
    #: optional mask postprocessor (largest connected component), installed
    #: by the trainer from the ``largest_cc`` config key
    postprocess = None

    def __init__(self, with_sp: bool = True):
        if not with_sp:  # FlapRecDoubleOut configuration
            self.test_dataset_class = ds.NiftiImageDataset
            self.append_atlas = False

    def _post(self, hard: np.ndarray) -> np.ndarray:
        return self.postprocess(hard) if self.postprocess else hard

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
