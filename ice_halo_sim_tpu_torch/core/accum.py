"""Spectral sort fold (port of the kernel-path subset of
``ice_halo_sim_tpu.core.accum``).

Scatter-add of (pixel, wavelength-pool index, weight) rows into an
[P, 3] XYZ image as: one unstable sort of u32 keys ``pixel * 2K | wl * 2``
together with one marker row per pixel (low bits 2K-1), the fused basis +
segmented scan (K4) leaving each pixel's total on its marker row, and the
marker extraction (K5 pack + K3 scatter) that makes the dense image.

The sort is ``torch.sort`` (the JAX package's is XLA's, not a Pallas
kernel). Key and weight ride as one int64 per row: the key XOR 0x80000000
(so signed order is u32 order) in the high word and the weight's bits in
the low word; ties between equal keys land in any order, which every
consumer ignores.

Kernel-backed stages take a ``ks`` KernelSet (kernels/__init__.py):
the wrappers or the plain twins.
"""

from __future__ import annotations

import torch

from ice_halo_sim_tpu_torch.core.bits import F32, I32, I64, MASK32, to_bits

# Row-block size of the marker extraction (pack + scatter).
BLOCK = 4096


def spectral_key_bits(n_pixels: int, k_pool: int) -> bool:
    """True iff (pixel, wl-idx, marker) packs into a u32 sort key with the
    dead key 0xFFFFFFFF decoding to a pixel >= n_pixels."""
    return (n_pixels + 1) * 2 * k_pool <= (1 << 32)


def key_shift(k_pool: int) -> int:
    return (2 * k_pool).bit_length() - 1


def pack_spectral_keys(pix, w, wl_idx, n_pixels: int, k_pool: int):
    """Contribution rows -> (key int32 bits, w with dead rows zeroed).
    Dead rows (pixel out of range or w <= 0) key to 0xFFFFFFFF."""
    if k_pool & (k_pool - 1) or not spectral_key_bits(n_pixels, k_pool):
        raise ValueError(f"cannot pack P={n_pixels}, K={k_pool} into u32 keys")
    shift = key_shift(k_pool)
    valid = (pix >= 0) & (pix < n_pixels) & (w > 0.0)
    upix = torch.where(valid, pix, 0).to(I64)
    wl = torch.as_tensor(wl_idx).to(I64) & (k_pool - 1)
    key = torch.where(valid, (upix << shift) | (wl << 1), MASK32)
    return to_bits(key), torch.where(valid, w, 0.0)


def marker_keys(n_pixels: int, k_pool: int, device) -> torch.Tensor:
    p = torch.arange(n_pixels, dtype=I64, device=device)
    return to_bits((p << key_shift(k_pool)) | (2 * k_pool - 1))


def scatter_accumulate(acc, pix, vals):
    """Oracle: index_add_ of vals [N, C] at pixels pix (rows outside [0, P)
    are dropped)."""
    P = acc.shape[0]
    ok = (pix >= 0) & (pix < P)
    out = acc.clone()
    out.index_add_(0, pix[ok].to(I64), vals[ok])
    return out


def sort_keys(keys, w):
    """Unstable sort of (u32 key bits, f32 weight) rows by key."""
    hi = (keys ^ torch.tensor(-(1 << 31), dtype=I32, device=keys.device)).to(I64)
    lo = w.contiguous().view(I32).to(I64) & MASK32
    s, _ = torch.sort(hi * (1 << 32) + lo)
    sk = ((s >> 32).to(I32)) ^ torch.tensor(-(1 << 31), dtype=I32, device=keys.device)
    sw = (s & MASK32).to(I64)
    sw = torch.where(sw >= 1 << 31, sw - (1 << 32), sw).to(I32).view(F32)
    return sk, sw


def _marker_extract(key2, seg_cols, P: int, ks, block: int = BLOCK):
    """Dense [P, 3] from scanned rows: key2 is the pixel id at marker rows
    (in global pixel order) and >= P elsewhere. Pack each block's markers
    to its front (K5), then scatter block g's rows to the exclusive cumsum
    of the marker counts (K3)."""
    M = key2.shape[0]
    G = M // block
    if G * block != M:
        raise ValueError(f"{M} rows are not a multiple of block {block}")
    pcols, m_cnt = ks.pack_payload_blocks(key2, list(seg_cols), P, block)
    start = torch.cumsum(m_cnt.to(I64), dim=0) - m_cnt.to(I64)
    dense = ks.scatter_blocks_multi(
        [c.view(G, block) for c in pcols], start.to(I32), P, block
    )
    return torch.stack(dense, dim=-1)


def _pad_to_block(keys, w, block: int = BLOCK):
    pad = -(-keys.shape[0] // block) * block - keys.shape[0]
    if pad:
        keys = torch.cat([keys, torch.full((pad,), -1, dtype=I32, device=keys.device)])
        w = torch.cat([w, torch.zeros(pad, dtype=w.dtype, device=w.device)])
    return keys, w


def fold_spectral_keys(acc, key, w, k_pool: int, basis_tbl, ks):
    """Full fold (no lane specs): contribution rows + P markers -> sort ->
    K4 -> marker extraction, added to acc [P, 3]."""
    P = acc.shape[0]
    keys = torch.cat([key, marker_keys(P, k_pool, key.device)])
    w_all = torch.cat([w, torch.zeros(P, dtype=w.dtype, device=w.device)])
    keys, w_all = _pad_to_block(keys, w_all)
    sk, sw = sort_keys(keys, w_all)
    seg, key2 = ks.fused_scan_call(sk, sw, basis_tbl, key_shift(k_pool), k_pool,
                                   emit_key2=True)
    return acc + _marker_extract(key2, seg, P, ks)


def fold_spectral_keys_premerged(acc, keys, w, k_pool: int, basis_tbl, ks):
    """Fold over rows that already hold the P marker keys (the K3 scatter's
    marker tail); rows outside contributions and markers are (0, 0) or
    (0xFFFFFFFF, 0), which fold to nothing."""
    P = acc.shape[0]
    M = keys.shape[0]
    if M % BLOCK:
        raise ValueError(f"{M} rows are not a multiple of block {BLOCK}")
    sk, sw = sort_keys(keys, w)
    seg, key2 = ks.fused_scan_call(sk, sw, basis_tbl, key_shift(k_pool), k_pool,
                                   emit_key2=True)
    return acc + _marker_extract(key2, seg, P, ks)

