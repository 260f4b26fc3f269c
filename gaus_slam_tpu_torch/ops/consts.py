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


def step_table(key, entries, device) -> torch.Tensor:
    """A float32 table indexed by a device step counter: ``entries()``
    gives its host values (made once per key and device, with
    ``cached``). A captured step reads its per-step scalars (a bias
    correction, a learning rate) from such a table through ``at``, so the
    graph bakes the table, never the value of one step."""
    return cached(("step_table",) + tuple(key),
                  lambda: np.asarray(entries(), dtype=np.float32), device)


def at(table: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """``table[min(step, len - 1)]`` as a 0-d tensor, indexed on the
    device (the last entry holds for every later step)."""
    i = torch.clamp(step, max=table.shape[0] - 1).reshape(1)
    return table.index_select(0, i).reshape(())


def host_scalar_divisor(c, device) -> np.float32:
    """What ``x / c`` multiplies or divides by for a host float ``c``
    and a float32 tensor ``x`` on ``device``: CUDA divides by a host
    scalar as a multiplication by its reciprocal, taken in double and
    rounded to float32 (PyTorch 2.11 on the H100, chip_smoke phase 13);
    the CPU divides by c rounded to float32. A table of these and
    ``div_by_entry`` give the same bits as the host scalar did."""
    if torch.device(device).type == "cuda":
        return np.float32(1.0 / float(c))
    return np.float32(c)


def div_by_entry(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``x / c`` for the host float ``c`` behind the table entry ``d``
    (``host_scalar_divisor``)."""
    return x * d if x.is_cuda else x / d
