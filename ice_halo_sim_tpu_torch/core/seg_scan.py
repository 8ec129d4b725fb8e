"""Fused basis expansion + segmented inclusive scan (port of K4,
``ice_halo_sim_tpu.core.pallas_scan.fused_scan_call``), and the same scan
with the marker extraction after it folded in (``fused_scan_extract``).

Over sorted fold rows (key u32 bits in int32, weight f32):
  chans[c][i] = tbl[(key >> 1) & (K-1), c] * w      (float32 product)
  seg[c][i]   = inclusive sum of chans[c] over the run of equal key >> shift
  key2[i]     = key >> shift at marker rows (low bits 2K-1), else 0xFFFFFFFF

``fused_scan_call`` returns seg (and key2); ``fused_scan_extract`` returns
the dense [P, 3] image of the marker rows: row pix holds seg at the marker
of pixel pix (the pixel's total), zero for a pixel whose marker is not among
the rows. Its plain version is the per-row scan with each marker row's
totals stored at its pixel; on sorted rows that is what the block pack and
block scatter of the markers (``accum._marker_extract``) give.

Both versions sum in float64 and round once to float32, so they agree to
about an ulp; against the TPU kernel (float32 sums in another order) the
tolerance is the summation order. The CUDA kernel (csrc/seg_scan.cu) serves
both wrappers: one pass over the rows, writing per row or at the markers.
"""

from __future__ import annotations

import torch

from ice_halo_sim_tpu_torch.core.bits import F32, I32, I64, from_bits, to_bits
from ice_halo_sim_tpu_torch.kernels import build

_TILE = 2048  # rows per thread block (csrc/seg_scan.cu kTile)
_MAX_K = 4096


def fused_scan_call_plain(sk, sw, basis_tbl, shift: int, k_pool: int,
                          emit_key2: bool = False):
    """Plain twin: (chans [3 x M f32], key2 [M] int32 bits) or chans."""
    k = from_bits(sk)
    M = k.shape[0]
    wl = (k >> 1) & (k_pool - 1)
    tbl = basis_tbl.to(device=sk.device, dtype=F32)
    vals = (tbl[wl] * sw[:, None]).to(torch.float64)
    pix = k >> shift
    flag = torch.ones(M, dtype=torch.bool, device=sk.device)
    if M > 1:
        flag[1:] = pix[1:] != pix[:-1]
    seg_id = torch.cumsum(flag.to(I64), dim=0) - 1
    cs = torch.cumsum(vals, dim=0)
    before = torch.cat([torch.zeros((1, 3), dtype=cs.dtype, device=cs.device), cs[:-1]])
    seg_base = before[flag]
    out = (cs - seg_base[seg_id]).to(F32)
    chans = [out[:, c].contiguous() for c in range(3)]
    if not emit_key2:
        return chans
    mmask = 2 * k_pool - 1
    key2 = to_bits(torch.where((k & mmask) == mmask, pix, 0xFFFFFFFF))
    return chans, key2


def fused_scan_extract_plain(sk, sw, basis_tbl, shift: int, k_pool: int, n_pixels: int):
    """Plain twin of the fused form: the per-row scan, then each marker
    row's totals stored at its pixel (< n_pixels). Returns [n_pixels, 3]
    float32."""
    chans, key2 = fused_scan_call_plain(sk, sw, basis_tbl, shift, k_pool, emit_key2=True)
    pix = from_bits(key2)
    at = pix < n_pixels
    img = torch.zeros((n_pixels, 3), dtype=F32, device=sk.device)
    img[pix[at]] = torch.stack(chans, dim=1)[at]
    return img


def _checked(sk, sw, basis_tbl, k_pool: int):
    if k_pool & (k_pool - 1) or not 1 <= k_pool <= _MAX_K:
        raise ValueError(f"k_pool must be a power of two <= {_MAX_K}, got {k_pool}")
    if sk.dtype != I32 or sw.dtype != F32 or sk.shape != sw.shape or sk.dim() != 1:
        raise ValueError("the fused scan takes [M] int32 key bits and float32 weights")
    dev = sk.device
    tbl = basis_tbl.to(device=dev, dtype=F32).contiguous()
    if tuple(tbl.shape) != (k_pool, 3):
        raise ValueError(f"basis table must be [{k_pool}, 3], got {tuple(tbl.shape)}")
    M = sk.shape[0]
    n_tiles = max(1, -(-M // _TILE))
    # The tile counter and the tiles' published flags (zeroed), and the
    # tiles' aggregates.
    state = torch.zeros(n_tiles + 1, dtype=I32, device=dev)
    agg = torch.empty(3 * n_tiles, dtype=torch.float64, device=dev)
    return sk.contiguous(), sw.contiguous(), tbl, M, state, agg


def fused_scan_call(sk, sw, basis_tbl, shift: int, k_pool: int,
                    emit_key2: bool = False):
    """K4 wrapper, per-row form: plain twin on the CPU, the CUDA kernel
    (csrc/seg_scan.cu) on a CUDA tensor."""
    if sk.device.type == "cpu":
        return fused_scan_call_plain(sk, sw, basis_tbl, shift, k_pool, emit_key2)
    sk, sw, tbl, M, state, agg = _checked(sk, sw, basis_tbl, k_pool)
    dev = sk.device
    chans = [torch.empty(M, dtype=F32, device=dev) for _ in range(3)]
    key2 = torch.empty(M, dtype=I32, device=dev) if emit_key2 else None
    lib = build.lib()
    with torch.cuda.device(dev):
        code = lib.iht_fused_scan(
            sk.data_ptr(), sw.data_ptr(), tbl.data_ptr(), k_pool, shift, M,
            chans[0].data_ptr(), chans[1].data_ptr(), chans[2].data_ptr(),
            build.ptr(key2), state.data_ptr(), agg.data_ptr(), build.stream_ptr(dev),
        )
    build.check(code, "fused_scan")
    build.LAUNCHES["fused_scan"] += 1
    return (chans, key2) if emit_key2 else chans


def fused_scan_extract(sk, sw, basis_tbl, shift: int, k_pool: int, n_pixels: int):
    """K4 wrapper, extract form (the spectral folds' scan and marker
    extraction in one launch): [n_pixels, 3] float32. Plain twin on the CPU,
    the CUDA kernel on a CUDA tensor."""
    if sk.device.type == "cpu":
        return fused_scan_extract_plain(sk, sw, basis_tbl, shift, k_pool, n_pixels)
    if not 0 <= n_pixels < 1 << 31:
        raise ValueError(f"n_pixels {n_pixels} out of range")
    sk, sw, tbl, M, state, agg = _checked(sk, sw, basis_tbl, k_pool)
    img = torch.zeros((n_pixels, 3), dtype=F32, device=sk.device)
    lib = build.lib()
    with torch.cuda.device(sk.device):
        code = lib.iht_fused_scan_extract(
            sk.data_ptr(), sw.data_ptr(), tbl.data_ptr(), k_pool, shift, M, img.data_ptr(),
            n_pixels, state.data_ptr(), agg.data_ptr(), build.stream_ptr(sk.device),
        )
    build.check(code, "fused_scan_extract")
    build.LAUNCHES["fused_scan_extract"] += 1
    return img
