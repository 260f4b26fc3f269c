"""Host data on the device without a host wait inside a step.

PyTorch copies pageable host memory to the card with a blocking copy
(``torch.tensor(..., device=)``, ``torch.as_tensor(..., device=)``): the
host waits until the stream has run everything queued before the copy.
Inside a step that is a wait per call. Two ways out:

  * ``constant`` / ``cached``: a tensor that depends only on host values
    of the run (a camera's intrinsics, a tile grid) is made once per
    (key, device), at its first use, with that one blocking copy, and
    read from then on. A filled entry is never written again, so a
    reader on any stream sees the values: the blocking copy has finished
    before any reader can be queued.
  * ``host_to_device``: host data that changes per call (a pose) goes
    through pinned memory with a non-blocking copy on the current
    stream. PyTorch's caching host allocator keeps the pinned block until
    the copy has run.
"""
from __future__ import annotations

import numpy as np
import torch

_CACHE: dict = {}


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def cached(key, make, device) -> torch.Tensor:
    """``torch.as_tensor(make())`` on ``device``, made once per (key,
    device); ``make`` returns host data and runs only on the first call."""
    dev = _device(device)
    t = _CACHE.get((key, dev))
    if t is None:
        t = torch.as_tensor(make(), device=dev)
        _CACHE[(key, dev)] = t
    return t


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype)`` on ``device`` (``values`` a
    number or nested tuples of numbers), made once. The same float32
    numbers as building it per call: bit-equal."""
    return cached(("constant", dtype, values),
                  lambda: torch.tensor(values, dtype=dtype), device)


def host_to_device(a, device, dtype: torch.dtype = torch.float32
                   ) -> torch.Tensor:
    """Host data (numpy, nested lists) as a ``dtype`` tensor on
    ``device``: on a card from pinned memory with a non-blocking copy on
    the current stream, elsewhere the host tensor itself."""
    t = torch.as_tensor(np.asarray(a), dtype=dtype)
    dev = torch.device(device)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)
