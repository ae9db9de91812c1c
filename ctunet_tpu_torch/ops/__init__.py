from .codecs import hard_segm, one_hot
from .losses import dice_coeff, dice_loss, hausdorff, softmax_cross_entropy
from .postprocess import largest_cc, largest_cc_device, threshold
from .preprocess import (
    dilate,
    erode,
    erode_dilate,
    fixed_pad,
    hu_window,
    pad_to_multiple,
    resample_to_shape,
    resample_to_spacing,
    unpad,
)
from .synthesis import (
    box_keep_mask,
    flap_keep_mask,
    flap_rec_transform,
    random_blank_patch,
    random_flip,
    random_nonzero_voxel,
    salt_and_pepper,
    skull_random_hole,
    sphere_keep_mask,
)
from .warp import (
    affine_warp,
    cranioplasty_transform,
    random_affine,
    random_elastic,
    random_flip_s,
)

# the names of ``ctunet_tpu.ops.__all__``, each from its counterpart module;
# random functions take a ``torch.Generator`` where JAX takes a key
__all__ = [
    "hard_segm",
    "one_hot",
    "largest_cc",
    "largest_cc_device",
    "threshold",
    "affine_warp",
    "cranioplasty_transform",
    "random_affine",
    "random_elastic",
    "random_flip_s",
    "dice_coeff",
    "dice_loss",
    "hausdorff",
    "softmax_cross_entropy",
    "dilate",
    "erode",
    "erode_dilate",
    "fixed_pad",
    "hu_window",
    "pad_to_multiple",
    "resample_to_shape",
    "resample_to_spacing",
    "unpad",
    "box_keep_mask",
    "flap_keep_mask",
    "flap_rec_transform",
    "random_blank_patch",
    "random_flip",
    "random_nonzero_voxel",
    "salt_and_pepper",
    "skull_random_hole",
    "sphere_keep_mask",
]
