"""Start the ranks of a one-host run as processes of this one.

``spawn(fn, world, args)`` starts ``world`` processes (``spawn`` start
method, so a parent that already holds the card may use it), each with
``CTUNET_COORDINATOR`` (a free ``localhost`` port), ``CTUNET_NUM_PROCESSES``
and ``CTUNET_PROCESS_ID`` set, so ``initialize_from_params`` (and ``Model``
with ``b_distributed``) brings the group up from the environment. Each
calls ``fn(rank, *args)``; ``spawn`` returns the ranks' return values in
rank order, or raises with the traceback of the first rank that failed.
``fn`` must be importable by name (a module-level function) and return
something picklable (tensors travel by value). Across hosts, start one
process per device with those variables set instead (README,
Multi-device).
"""

from __future__ import annotations

import os
import pickle
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Sequence

SPAWN_TIMEOUT_S = 600.0  # how long spawn waits for every rank's result


def free_port() -> int:
    """A TCP port of ``localhost`` that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(fn, rank: int, world: int, port: int, args, results) -> None:
    os.environ.update(CTUNET_COORDINATOR=f"localhost:{port}",
                      CTUNET_NUM_PROCESSES=str(world),
                      CTUNET_PROCESS_ID=str(rank))
    try:
        out = (rank, True, fn(rank, *args))
    except BaseException:  # noqa: BLE001  the parent reports it
        out = (rank, False, traceback.format_exc())
    finally:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
    # plain pickle: a tensor travels by value, not through shared memory
    # that dies with this process
    results.put(pickle.dumps(out))


def spawn(fn: Callable, world: int, args: Sequence[Any] = ()) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``world`` new processes (module
    docstring); every process is joined or killed before it returns."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_run, args=(fn, r, world, port, tuple(args),
                                            results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while len(got) < world:
            try:
                rank, ok, value = pickle.loads(results.get(timeout=1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and no result")
                if time.monotonic() > deadline:
                    missing = sorted(set(range(world)) - set(got))
                    raise TimeoutError(f"ranks {missing} gave no result in "
                                       f"{SPAWN_TIMEOUT_S} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            got[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30 if len(got) == world else 1)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]
