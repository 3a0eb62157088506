"""Host->device input pipeline (counterpart of ``mlx_vae_tpu/utils/prefetch.py``).

The ``--host_data`` feed: a small look-ahead queue copies the next batches
to the device while the current step computes. On a CUDA device each numpy
array is pinned and copied with ``non_blocking=True``, so the copy rides the
current stream behind the queued steps and the host never waits for it; on
the CPU the arrays become tensors in place.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np
import torch


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """``x`` as a tensor on ``device``: pinned and copied without blocking
    the host on CUDA."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       device=torch.device("cpu")) -> Iterator:
    """Yield items from ``iterator`` moved to ``device`` ahead by ``size``
    steps. Items may be arrays or tuples/lists of arrays."""
    device = torch.device(device)
    queue = collections.deque()
    it = iter(iterator)

    def put(item):
        if isinstance(item, (tuple, list)):
            return type(item)(to_device(x, device) for x in item)
        return to_device(item, device)

    for item in it:
        queue.append(put(item))
        if len(queue) > size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
