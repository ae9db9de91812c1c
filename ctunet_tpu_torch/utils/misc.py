"""Small host-side helpers (paths, timing).

The non-JAX part of ``ctunet_tpu/utils/misc.py``: ``makedir``
(ref ``ctunet/utilities.py:22-32``) and the ``tic``/``toc_eps`` epoch ETA
(``utilities.py:271-304``).
"""

from __future__ import annotations

import os
import timeit
from typing import Optional


def makedir(path: Optional[str] = None) -> Optional[str]:
    """Create the folder at ``path`` if missing; return the path."""
    if not path:
        return None
    os.makedirs(path, exist_ok=True)
    return path


def tic() -> float:
    """Start a wall-clock timer."""
    return timeit.default_timer()


def toc_eps(ep_time: float, n_epoch: int, epochs: int,
            print_out: bool = True) -> float:
    """Stop the timer and print estimated remaining training time."""
    ep_time = timeit.default_timer() - ep_time
    remaining = int(ep_time * (epochs + 1 - n_epoch))
    hours = remaining // 3600
    minutes = (remaining - hours * 3600) // 60
    if print_out:
        print(
            "({}%) Remaining time (HH:MM): {}:{}\n".format(
                int(100 * n_epoch / float(epochs)), hours, minutes
            )
        )
    return ep_time
