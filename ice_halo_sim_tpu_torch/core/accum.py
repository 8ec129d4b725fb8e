"""Spectral sort fold and the block compactions before it (port of
``ice_halo_sim_tpu.core.accum``), with the dense-value fold
``sort_accumulate`` for scenes whose keys do not pack.

Scatter-add of (pixel, wavelength-pool index, weight) rows into an
[P, 3] XYZ image as: one stable sort of u32 keys ``pixel * 2K | wl * 2``
together with one marker row per pixel (low bits 2K-1), then the fused basis
+ segmented scan (K4), which leaves each pixel's total on its marker row and
writes it into the dense image (``seg_scan.fused_scan_extract``). Where the
scan runs on its own (the colour lanes, ``sort_accumulate``), the marker
rows are extracted by K5 pack + K3 scatter (``_marker_extract``).

The sort is ``ks.sort_pairs`` (core/radix_sort.py: a radix sort of (key,
weight) pairs on the card; the JAX package's is XLA's, not a Pallas kernel)
over the key's low ``sort_end_bit(P, K)`` bits, which order every pixel's
rows and put the dead key behind every marker. Equal keys keep their input
order.

With colour-class lanes (L > 0) the JAX package leaves its fused scan
kernel: it expands the basis, builds the lanes from the mask column and
takes the per-pixel totals in XLA. Here that part is plain PyTorch
(``_segmented_totals``, a float64 running sum instead of the TPU's chunked
two-level float32 scan: same totals, rounded once), and the extraction
still goes through K5 and K3, in groups of at most three payloads.

``compact_valid`` and ``compact_by_key`` shorten the rows to a static
prefix. The JAX package composes the first from K6 (``pallas_ops.py:301``)
and one K3' (``:549``) per column; here it is one launch of
``block_ops.compact_rows``, which reads the rows once and writes the kept
rows once, in place of K6's whole slab written and read back. The second
sorts inside each block (``torch.argsort``; the JAX package's block sort is
XLA's, not Pallas) and hands the order to one launch of the block scatter
for every column, in place of a gather and a K3' per column. The TPU's
block sort is unstable; here the order inside a block is a function of the
rows (key, then row index), so the CPU and the card agree.

Kernel-backed stages take a ``ks`` KernelSet (kernels/__init__.py):
the wrappers or the plain twins.
"""

from __future__ import annotations

import torch

from ice_halo_sim_tpu_torch.core import radix_sort
from ice_halo_sim_tpu_torch.core.bits import F32, I32, I64, MASK32, from_bits, to_bits
from ice_halo_sim_tpu_torch.core.block_ops import exclusive_starts as _exclusive_starts
from ice_halo_sim_tpu_torch.core.block_ops import pad_rows as _pad_cols
from ice_halo_sim_tpu_torch.utils import profiling

# Row-block size of the marker extraction (pack + scatter).
BLOCK = 4096


def spectral_key_bits(n_pixels: int, k_pool: int) -> bool:
    """True iff (pixel, wl-idx, marker) packs into a u32 sort key with the
    dead key 0xFFFFFFFF decoding to a pixel >= n_pixels."""
    return (n_pixels + 1) * 2 * k_pool <= (1 << 32)


def key_shift(k_pool: int) -> int:
    return (2 * k_pool).bit_length() - 1


def sort_end_bit(n_pixels: int, k_pool: int) -> int:
    """The fewest low key bits that order the fold's rows: every key and
    marker lies below (P + 1) * 2K - 1, and the dead key 0xFFFFFFFF masked
    to these bits does not, so it decodes to a pixel >= P and sorts behind
    every marker. At most 32 where spectral_key_bits holds."""
    return ((n_pixels + 1) * 2 * k_pool - 1).bit_length()


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


def sort_accumulate(acc, pix, vals, ks):
    """Scatter-free accumulate of dense value rows: acc + the per-pixel sums
    of vals. acc [P, C] float32; pix [N] (rows outside [0, P) are dropped);
    vals [N, C] float32 >= 0. The fold of a scene whose (pixel, wavelength)
    keys do not pack into 32 bits: keys are pixel * 2 for a row and pixel *
    2 + 1 for the pixel's marker, one sort by (key, row), the per-pixel
    totals in float64 and the marker extraction (K5 + K3)."""
    P, C = acc.shape
    dev = acc.device
    if 2 * P + 2 > MASK32:
        raise ValueError(f"{P} pixels do not fit the 32-bit marker keys")
    n = pix.shape[0]
    if n == 0:
        return acc.clone()
    pix = pix.to(I64)
    valid = (pix >= 0) & (pix < P)
    keys = torch.cat([torch.where(valid, pix * 2, 2 * P),
                      torch.arange(P, dtype=I64, device=dev) * 2 + 1])
    M = keys.shape[0]
    pad = -(-M // BLOCK) * BLOCK - M
    if pad:
        keys = torch.cat([keys, torch.full((pad,), 2 * P + 2, dtype=I64, device=dev)])
    row = torch.arange(M + pad, dtype=I64, device=dev)
    s, _ = torch.sort(_sort_word(keys, row))
    order = s & MASK32
    sk = (s >> 32) + (1 << 31)
    src = torch.clamp_max(order, n - 1)
    live = (order < n) & valid[src]
    chans = [torch.where(live, vals[src, c], 0.0) for c in range(C)]
    seg = _segmented_totals(to_bits(sk), chans, 1, P)
    key2 = to_bits(torch.where((sk & 1) == 1, sk >> 1, 0x7FFFFFFF))
    return acc + _marker_extract(key2, seg, P, ks)


def accumulate(acc, pix, vals, method: str, ks):
    """Dense-value accumulate by 'scatter' (index_add_), 'sort'
    (sort_accumulate) or 'auto' (sort on a CUDA device, scatter on the
    CPU)."""
    if method == "auto":
        method = "sort" if acc.device.type == "cuda" else "scatter"
    if method == "sort":
        return sort_accumulate(acc, pix, vals, ks)
    if method == "scatter":
        return scatter_accumulate(acc, pix, vals)
    raise ValueError(f"method must be 'scatter', 'sort' or 'auto', got {method!r}")


def sort_keys(keys, w, ks=None, end_bit: int = 32):
    """Stable sort of (u32 key bits, f32 weight) rows by the key's bits [0,
    end_bit) (the stage ``sort`` of a timed batch: utils/profiling.py), by
    ``ks.sort_pairs``; without ks by ``radix_sort.sort_pairs``, which takes
    the plain twin for a CPU tensor. The folds pass sort_end_bit(P, K): their
    keys are a pixel's or 0xFFFFFFFF."""
    profiling.stage("sort")
    return (radix_sort.sort_pairs if ks is None else ks.sort_pairs)(keys, w, end_bit)


_MAX_PAYLOADS = 3  # columns per launch of the pack kernel (K5)


def _marker_extract(key2, seg_cols, P: int, ks, block: int = BLOCK):
    """Dense [P, C] from scanned rows: key2 is the pixel id at marker rows
    (in global pixel order) and >= P elsewhere. Pack each block's markers
    to its front (K5), then scatter block g's rows to the exclusive cumsum
    of the marker counts (K3); more than three columns go in groups."""
    M = key2.shape[0]
    G = M // block
    if G * block != M:
        raise ValueError(f"{M} rows are not a multiple of block {block}")
    seg_cols = list(seg_cols)
    dense = []
    start = None
    for i in range(0, len(seg_cols), _MAX_PAYLOADS):
        pcols, m_cnt = ks.pack_payload_blocks(key2, seg_cols[i:i + _MAX_PAYLOADS], P, block)
        if start is None:
            start = _exclusive_starts(m_cnt)
        dense += ks.scatter_blocks_multi([c.view(G, block) for c in pcols], start, P, block)
    return torch.stack(dense, dim=-1)


def _sort_word(k, row):
    """One signed int64 per row that orders by (u32 key, row index): the key
    less 2^31 in the high word, the row (< 2^32) in the low word."""
    return (k - (1 << 31)) * (1 << 32) + row


def compact_valid(key, cols, keep: int, ks, block: int = BLOCK):
    """Rows with key != 0xFFFFFFFF into a prefix of `keep` rows, in their
    original order (the fold's prepass; its sort follows, so the order does
    not matter): ``ks.compact_rows``, one launch on the card.

    Returns ((key', cols'...), n_valid tensor). Exact when n_valid <= keep,
    which the caller guards. Rows past the last valid row are (0xFFFFFFFF,
    0) from the last block's tail, then (0, 0): zero-weight rows that fold
    to nothing."""
    outs, n_valid = ks.compact_rows(key, list(cols), keep, block)
    return tuple(outs), n_valid


def compact_by_key(key, cols, keep: int, ks, block: int = BLOCK, with_key: bool = True):
    """Rows with key != 0xFFFFFFFF into a prefix of `keep` rows, each block
    sorted by key (ties by row: the order is a function of the rows); the
    block order goes to one block scatter of every column as its in-block
    permutation. The continuation between layers uses it: its key orders a
    block's rows by weight bucket and a hash of the row.

    Returns ((key', cols'...), n_valid tensor), as compact_valid does;
    without the key column when with_key is False (the columns are the
    same)."""
    key, cols = _pad_cols(key, cols, block)
    G = key.shape[0] // block
    kb = from_bits(key).view(G, block)
    counts = (kb != MASK32).sum(dim=1)
    start = _exclusive_starts(counts)
    row = torch.arange(block, dtype=I64, device=key.device)
    order = torch.argsort(_sort_word(kb, row[None, :]), dim=1).to(I32)
    vals = [x.view(G, block) for x in ((key, *cols) if with_key else cols)]
    return tuple(ks.scatter_blocks(vals, start, keep, block, perm=order)), counts.sum()


_SCAN_TILE = 4096


def _rows_cumsum(x):
    """cumsum along the rows of a 2-D tensor, with one zero row added: a
    cumsum that reduces to one row is a flat scan, which torch runs on a CUDA
    tensor through CUB's decoupled look-back, whose float sums depend on
    timing; the per-row scan adds in a fixed order."""
    return torch.cat([x, torch.zeros_like(x[:1])]).cumsum(dim=1)[:-1]


def cumsum_fixed_order(v):
    """Inclusive cumsum of a 1-D float tensor, the same bits on every run:
    running sums inside tiles of _SCAN_TILE rows, then each tile's offset,
    the running sum of the tiles' totals before it."""
    n = v.shape[0]
    x = torch.cat([v, v.new_zeros(-n % _SCAN_TILE)]).view(-1, _SCAN_TILE)
    rows = _rows_cumsum(x)
    ends = _rows_cumsum(rows[:, -1][None, :])[0]
    offset = torch.cat([ends.new_zeros(1), ends[:-1]])
    return (rows + offset[:, None]).view(-1)[:n]


def _segmented_totals(sk, chans, shift: int, n_pixels: int):
    """Per-pixel running sums over sorted rows: the last row of each run of
    equal ``key >> shift`` holds that pixel's total. chans: list of [M]
    float32 >= 0. Summed in float64 in a fixed order (cumsum_fixed_order),
    rounded once.

    Each channel is one flat running sum, and a run's base (the sum before
    its first row) goes through a table indexed by the pixel: the first row
    of each run writes it, every row of the run reads it. Rows past the
    pixels (the dead key) are one run, slot n_pixels; rows that are no
    first row write to a spare slot that nobody reads."""
    pix = torch.clamp_max(from_bits(sk) >> shift, n_pixels)
    first = torch.ones_like(pix, dtype=torch.bool)
    first[1:] = pix[1:] != pix[:-1]
    slot = torch.where(first, pix, n_pixels + 1)
    out = []
    for ch in chans:
        v = ch.to(torch.float64)
        cs = cumsum_fixed_order(v)
        base = torch.zeros(n_pixels + 2, dtype=torch.float64, device=sk.device)
        base.scatter_(0, slot, cs - v)
        out.append((cs - base[pix]).to(F32))
    return out


def lane_members(mask, lane_specs):
    """Per colour class, which rows belong: mask [N] int64-held u32 bits;
    lane_specs ((bits, combine_all), ...)."""
    return [((mask & b) == b) if combine_all else ((mask & b) != 0)
            for b, combine_all in lane_specs]


def fold_spectral_keys(acc, key, w, k_pool: int, basis_tbl, ks, lane_specs=(),
                       mask=None, prefix_len=None):
    """Full fold: contribution rows + P markers -> one sort -> per-pixel
    totals -> marker extraction, added to acc [P, 3 + L].

    Without lanes K4 makes the totals and the image. With lane_specs ((bits,
    combine_all) per colour class) the mask column (int32 u32 bits) rides
    the sort, and the basis, the lanes and the totals are plain torch.
    prefix_len (a multiple of the block): scan and extract only that many
    sorted rows, which is exact iff live rows + P <= prefix_len (the
    caller's to guard)."""
    P = acc.shape[0]
    L = len(lane_specs)
    if acc.shape[1] != 3 + L:
        raise ValueError(f"accumulator has {acc.shape[1]} channels, not {3 + L}")
    shift = key_shift(k_pool)
    profiling.stage("sort")
    keys = torch.cat([key, marker_keys(P, k_pool, key.device)])
    w_all = torch.cat([w, torch.zeros(P, dtype=w.dtype, device=w.device)])
    keys, (w_all,) = _pad_cols(keys, [w_all], BLOCK)
    M = keys.shape[0]
    if prefix_len is not None and prefix_len < M and prefix_len % BLOCK:
        raise ValueError(f"prefix_len {prefix_len} is not a multiple of {BLOCK}")
    cut = prefix_len if prefix_len is not None and prefix_len < M else M
    if L == 0:
        sk, sw = sort_keys(keys, w_all, ks, sort_end_bit(P, k_pool))
        profiling.stage("scan")
        dense = ks.fused_scan_extract(sk[:cut], sw[:cut], basis_tbl, shift, k_pool, P)
        profiling.stage("rest")
        return acc + dense
    if mask is None:
        raise ValueError("lane_specs need the mask column")
    # Sort (key, row) pairs and gather the two payload columns by row.
    row = torch.arange(M, dtype=I64, device=keys.device)
    s, _ = torch.sort(_sort_word(from_bits(keys), row))
    s = s[:cut]
    order = s & MASK32
    k_sorted = (s >> 32) + (1 << 31)
    sk = to_bits(k_sorted)
    sw = w_all[order]
    n = mask.shape[0]
    smask = torch.where(order < n, from_bits(mask)[torch.clamp_max(order, n - 1)], 0)
    profiling.stage("scan")
    basis = basis_tbl.to(device=keys.device, dtype=F32)[(k_sorted >> 1) & (k_pool - 1)]
    chans = [basis[:, c] * sw for c in range(3)]
    y = chans[1]
    chans += [torch.where(m, y, 0.0) for m in lane_members(smask, lane_specs)]
    seg = _segmented_totals(sk, chans, shift, P)
    mmask = 2 * k_pool - 1
    key2 = to_bits(torch.where((k_sorted & mmask) == mmask, k_sorted >> shift, MASK32))
    dense = _marker_extract(key2, seg, P, ks)
    profiling.stage("rest")
    return acc + dense


def fold_spectral_keys_premerged(acc, keys, w, k_pool: int, basis_tbl, ks):
    """Fold over rows that already hold the P marker keys (the K3 scatter's
    marker tail); rows outside contributions and markers are (0, 0) or
    (0xFFFFFFFF, 0), which fold to nothing."""
    P = acc.shape[0]
    M = keys.shape[0]
    if M % BLOCK:
        raise ValueError(f"{M} rows are not a multiple of block {BLOCK}")
    sk, sw = sort_keys(keys, w, ks, sort_end_bit(P, k_pool))
    profiling.stage("scan")
    dense = ks.fused_scan_extract(sk, sw, basis_tbl, key_shift(k_pool), k_pool, P)
    profiling.stage("rest")
    return acc + dense

