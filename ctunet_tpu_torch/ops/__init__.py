from .codecs import hard_segm
from .postprocess import largest_cc

__all__ = ["hard_segm", "largest_cc"]
