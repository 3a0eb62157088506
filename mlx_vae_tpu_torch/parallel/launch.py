"""Start one process per rank and join them (no JAX counterpart: JAX drives
every device from one process).

:func:`spawn` starts ``world`` processes with the ``spawn`` start method
(the parent may already hold a CUDA context, which a forked child cannot
use), each of which joins a process group through a ``FileStore`` in a
temporary directory (no TCP port to collide with another group on the same
host) and calls ``fn(rank, *args)``. Each rank's return value comes back to
the parent through a file in that directory. A child's exception is raised
again in the parent; at the first failure, or at ``timeout``, every other
child is killed, so nothing is left hanging.

On CUDA rank r takes card ``r % torch.cuda.device_count()``: several ranks
share a card when there are fewer cards than ranks (then only gloo will
do: NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist


class RankFailed(RuntimeError):
    """A rank raised (its traceback is the message) or died."""


def _run_rank(fn, rank: int, world: int, device: str, backend: str, tmp: str,
              args: tuple, timeout: float) -> None:
    torch.set_num_threads(1)
    err = os.path.join(tmp, f"error_{rank}.txt")
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(os.path.join(tmp, "store"), world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        path = os.path.join(tmp, f"result_{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(path + ".tmp", path)
    except BaseException:
        with open(err, "w") as f:
            f.write(traceback.format_exc())
        raise


def _why(tmp: str, r: int, code) -> str:
    err = os.path.join(tmp, f"error_{r}.txt")
    if os.path.exists(err):
        with open(err) as f:
            return f.read()
    return f"exit code {code} with no traceback"


def _kill(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(5)


def spawn(fn, world: int, device="cpu", backend: Optional[str] = None, args: tuple = (),
          timeout: Optional[float] = None) -> list:
    """Run ``fn(rank, *args)`` on ``world`` new ranks; returns their return
    values in rank order. ``fn`` is a module-level function (it is pickled
    by its import path) of a module that does not import JAX. ``backend``
    defaults to nccl on CUDA and gloo on the CPU. ``timeout`` (seconds,
    None: no limit) bounds the whole group."""
    from mlx_vae_tpu_torch.parallel.mesh import default_backend

    device = str(device)
    backend = backend or default_backend(device)
    limit = 1e9 if timeout is None else float(timeout)
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="mlx_vae_tpu_torch_ranks_")
    procs = []
    try:
        for r in range(world):
            p = ctx.Process(target=_run_rank, name=f"rank{r}", daemon=True,
                            args=(fn, r, world, device, backend, tmp, args, min(limit, 3600.0)))
            p.start()
            procs.append(p)
        deadline = time.monotonic() + limit
        alive = list(procs)
        while alive:
            left = deadline - time.monotonic()
            if left <= 0:
                _kill(procs)
                raise TimeoutError(f"{world} ranks of {getattr(fn, '__name__', fn)} "
                                   f"did not finish within {timeout}s; all killed")
            multiprocessing.connection.wait([p.sentinel for p in alive], timeout=left)
            for p in [p for p in alive if p.exitcode is not None]:
                alive.remove(p)
                if p.exitcode != 0:
                    # the others often fail in turn (a peer closed): give them
                    # a moment, then report every failed rank, the cause first
                    multiprocessing.connection.wait([q.sentinel for q in alive], timeout=2.0)
                    _kill(procs)
                    raise RankFailed("\n".join(
                        f"rank {r} of {world} failed:\n{_why(tmp, r, q.exitcode)}"
                        for r, q in sorted(enumerate(procs), key=lambda e: e[1] is not p)
                        if q.exitcode not in (0, None)))
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        _kill(procs)
        shutil.rmtree(tmp, ignore_errors=True)
