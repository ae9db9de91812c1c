from .codecs import hard_segm, one_hot
from .postprocess import largest_cc

__all__ = ["hard_segm", "largest_cc", "one_hot"]
