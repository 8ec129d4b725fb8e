"""The spectral sort key's layout (port of the key part of
``ice_halo_sim_tpu.core.accum``): a row's u32 key is ``pixel * 2K | wl * 2``
for a wavelength pool of K entries, a pixel's marker row ``pixel * 2K |
2K - 1``, and the dead key 0xFFFFFFFF. The fold itself is not copied: the
reference folds by ``index_add_`` (``oracle.py``).
"""

from __future__ import annotations


def spectral_key_bits(n_pixels: int, k_pool: int) -> bool:
    """True iff (pixel, wl-idx, marker) packs into a u32 sort key with the
    dead key 0xFFFFFFFF decoding to a pixel >= n_pixels."""
    return (n_pixels + 1) * 2 * k_pool <= (1 << 32)


def key_shift(k_pool: int) -> int:
    return (2 * k_pool).bit_length() - 1
