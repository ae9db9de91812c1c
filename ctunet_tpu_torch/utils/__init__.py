from .config import default_params, load_params, print_params_dict, set_cfg_params
from .misc import makedir, model_summary, tic, toc_eps, view
from .nifti import NiftiImage, read, write

__all__ = [
    "default_params",
    "load_params",
    "print_params_dict",
    "set_cfg_params",
    "makedir",
    "model_summary",
    "tic",
    "toc_eps",
    "view",
    "NiftiImage",
    "read",
    "write",
]
