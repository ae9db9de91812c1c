from .config import default_params, load_params, print_params_dict, set_cfg_params
from .misc import makedir, tic, toc_eps
from .nifti import NiftiImage, read, write

__all__ = [
    "default_params",
    "load_params",
    "print_params_dict",
    "set_cfg_params",
    "makedir",
    "tic",
    "toc_eps",
    "NiftiImage",
    "read",
    "write",
]
