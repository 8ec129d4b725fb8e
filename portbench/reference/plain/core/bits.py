"""u32 and f32 helpers for plain torch.

Two representations of u32 values, each where it serves:
  - arithmetic: int64 tensors holding values in [0, 2^32), masked to 32
    bits after every operation that can overflow (torch's CPU uint32 has
    no add, right shift or compare);
  - storage and kernel interfaces: int32 tensors holding the u32 BIT
    PATTERN (half the bytes; the CUDA kernels read them as uint32_t).

``sdiv`` and ``divs`` exist because torch does not always divide:
``python_scalar / tensor`` is ``tensor.reciprocal() * scalar``
(``Tensor.__rdiv__``), and on CUDA ``tensor / python_scalar`` multiplies by
the scalar's reciprocal. Both round twice; JAX and the CUDA kernels divide.
Every division by or of a python scalar in the port goes through them.
They make the scalar with ``torch.full`` on the tensor's device: a fill
launches a kernel with the value as its argument, where ``torch.tensor(s,
device=...)`` copies from host memory and synchronises, which a captured
CUDA graph may not do (engine/graph.py).

``const`` uploads a constant table once per device and keeps it, for the
same reason: the batch's samplers read small tables (hexagon directions,
latitude LUTs, filter paths) that would otherwise be copied to the card on
every batch.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
F32 = torch.float32
I32 = torch.int32
I64 = torch.int64


def u32(x):
    """Mask an int64 tensor (or python int) to 32 bits."""
    return x & MASK32


def to_bits(x64: torch.Tensor) -> torch.Tensor:
    """int64 u32 values -> int32 bit patterns."""
    x64 = x64 & MASK32
    return torch.where(x64 >= 1 << 31, x64 - (1 << 32), x64).to(I32)


def from_bits(x32: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 u32 values."""
    return x32.to(I64) & MASK32


def divs(t: torch.Tensor, s: float) -> torch.Tensor:
    """Correctly rounded ``t / s`` for a python scalar s."""
    return torch.div(t, torch.full((), s, dtype=t.dtype, device=t.device))


def sdiv(s: float, t: torch.Tensor) -> torch.Tensor:
    """Correctly rounded ``s / t`` for a python scalar s (cast to t's dtype,
    as JAX's weak typing does)."""
    return torch.div(torch.full((), s, dtype=t.dtype, device=t.device), t)


_CONSTS: dict = {}


def const(values, device, dtype=None) -> torch.Tensor:
    """`values` (an array-like of constants) as a tensor on `device`: on the
    CPU without a copy; on a CUDA device uploaded at most once per content
    and device and kept for the process (the tables are a few hundred bytes
    each). Callers must not write into the result."""
    dev = torch.device(device)
    arr = np.ascontiguousarray(values)
    if dev.type == "cpu":
        return torch.as_tensor(arr, dtype=dtype)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    key = (arr.tobytes(), arr.shape, arr.dtype.str, str(dtype), str(dev))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.as_tensor(arr, dtype=dtype, device=dev)
    return t
