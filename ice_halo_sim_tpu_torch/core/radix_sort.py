"""Stable radix sort of (u32 key, 32-bit payload) pairs over the key's bits
[0, end_bit): the spectral folds' sort (``accum.sort_keys``).

No Pallas kernel is displaced: the JAX package leaves this sort to XLA
(``lax.sort(..., num_keys=1)`` in ``ice_halo_sim_tpu.core.accum``). The CUDA
kernel (csrc/radix_sort.cu) is an LSD radix sort: one launch counts every
pass's digits, then one launch a pass of at most 8 bits ranks each tile's
rows stably and places them by a decoupled look-back over integer counts,
so ``passes(end_bit)`` passes of 16 B a row instead of torch.sort's eight
passes over an int64 word with an index payload.

The plain twin is ``torch.sort(..., stable=True)`` of the masked key and a
gather of the payload: the kernel gives its order bit for bit (equal
masked keys keep their input order).

Keys are int32 tensors holding u32 bit patterns; the payload is any 32-bit
dtype (moved as raw bits).
"""

from __future__ import annotations

import torch

from ice_halo_sim_tpu_torch.core.bits import I32, from_bits
from ice_halo_sim_tpu_torch.kernels import build

_TILE = 3072      # rows a onesweep block sorts (csrc/radix_sort.cu kTile)
_MAX_BITS = 8     # digit bits of one pass (kMaxBits)
_RADIX = 1 << _MAX_BITS
_HEAD = 4 * _RADIX + 4  # state words before the look-back words (kHead)
_MAX_ROWS = (1 << 30) - _TILE - 1


def passes(end_bit: int) -> int:
    """Digit passes of the kernel for end_bit (the kernel checks it)."""
    return -(-end_bit // _MAX_BITS)


def _checked(keys, vals, end_bit: int):
    if not 1 <= end_bit <= 32:
        raise ValueError(f"end_bit must be in [1, 32], got {end_bit}")
    if keys.dtype != I32 or vals.element_size() != 4 or keys.dim() != 1 \
            or keys.shape != vals.shape or keys.device != vals.device:
        raise ValueError("the radix sort takes [M] int32 key bits and [M] 32-bit payloads "
                         "on one device")
    if keys.shape[0] > _MAX_ROWS:
        raise ValueError(f"{keys.shape[0]} rows exceed the sort's {_MAX_ROWS}")


def sort_pairs_plain(keys, vals, end_bit: int = 32):
    """Plain twin: (keys, vals) in the stable order of the key's bits [0,
    end_bit)."""
    _checked(keys, vals, end_bit)
    order = torch.sort(from_bits(keys) & ((1 << end_bit) - 1), stable=True).indices
    return keys[order], vals[order]


def sort_pairs(keys, vals, end_bit: int = 32):
    """Radix sort wrapper: the plain twin for a CPU tensor, the CUDA kernel
    for a CUDA tensor. Returns new (keys, vals); the input is not written."""
    if keys.device.type == "cpu":
        return sort_pairs_plain(keys, vals, end_bit)
    _checked(keys, vals, end_bit)
    keys, vals = keys.contiguous(), vals.contiguous()
    M = keys.shape[0]
    if M == 0:
        return keys.clone(), vals.clone()
    n = passes(end_bit)
    k_out, v_out = torch.empty_like(keys), torch.empty_like(vals)
    k_alt, v_alt = (torch.empty_like(keys), torch.empty_like(vals)) if n > 1 else (None, None)
    state = torch.zeros(_HEAD + n * -(-M // _TILE) * _RADIX, dtype=I32, device=keys.device)
    lib = build.lib()
    with torch.cuda.device(keys.device):
        code = lib.iht_radix_sort_pairs(
            keys.data_ptr(), vals.data_ptr(), M, end_bit, n, k_out.data_ptr(), v_out.data_ptr(),
            build.ptr(k_alt), build.ptr(v_alt), state.data_ptr(), state.numel(),
            build.stream_ptr(keys.device),
        )
    build.check(code, "radix_sort")
    build.LAUNCHES["radix_sort"] += 1
    build.LAUNCHES["radix_sort_pass"] += n
    return k_out, v_out
