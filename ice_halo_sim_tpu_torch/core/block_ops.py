"""Block pack, block scatter and the one-pass row compaction (port of
``ice_halo_sim_tpu.core.pallas_ops``: K1 ``_pack_one_block``, K6
``pack_valid_blocks`` (:301), K5 ``pack_payload_blocks``, K3
``scatter_blocks_multi`` (:436) and K3' ``scatter_blocks`` (:549); and of
``ice_halo_sim_tpu.core.accum.compact_valid``, K6 then one K3' per column,
as ``compact_rows``).

Each function has a plain PyTorch twin (``*_plain``, any device) beside
its wrapper. The wrapper runs the twin for a CPU tensor and the CUDA
kernel (csrc/block_ops.cu) for a CUDA tensor; it never falls back.

All of them are bound by memory bandwidth on the card. The block scatter
(K3, K3', and P2 in ``probe_scatter``) is one kernel that owns output tiles
instead of searching per element: a thread block finds the source blocks
around its tile of output rows once, and every column of the call (up to 8,
with an optional in-block permutation) moves in one launch. ``compact_rows`` is
K6 and K3' in one pass: the rows are read once and the kept rows written
once, at their final place.

Keys are int32 tensors holding u32 bit patterns; payload columns are any
32-bit dtype (the kernels move them as raw bits).
"""

from __future__ import annotations

import torch

from ice_halo_sim_tpu_torch.core.bits import I32, I64, MASK32, from_bits, to_bits
from ice_halo_sim_tpu_torch.kernels import build

_KEY_TAIL = -1  # 0xFFFFFFFF as an int32 bit pattern
MAX_SCATTER_COLS = 8  # columns per launch of the block scatter
COMPACT_BLOCK = 4096  # the row block of compact_rows's kernel


def pad_rows(key, cols, block: int):
    """Pad rows to a block multiple with (0xFFFFFFFF, 0...)."""
    pad = -(-key.shape[0] // block) * block - key.shape[0]
    if pad:
        key = torch.cat([key, torch.full((pad,), _KEY_TAIL, dtype=I32, device=key.device)])
        cols = [torch.cat([c, torch.zeros(pad, dtype=c.dtype, device=c.device)])
                for c in cols]
    return key, list(cols)


def exclusive_starts(counts):
    c = counts.to(I64)
    return (torch.cumsum(c, dim=0) - c).to(I32)


def _check_marker_tail(marker_tail, out_len: int):
    t0, tlen, shift, low_or = (int(x) for x in marker_tail)
    if t0 < 0 or tlen < 0 or t0 + tlen > out_len:
        raise ValueError(
            f"marker_tail [{t0}, {t0 + tlen}) does not fit out_len {out_len}"
        )
    if not 0 <= shift < 32 or not 0 <= low_or <= MASK32:
        raise ValueError(f"marker_tail shift {shift} / low_or {low_or} out of range")
    if tlen and ((tlen - 1) << shift) > MASK32:
        raise ValueError("marker_tail keys overflow 32 bits")
    return t0, tlen, shift, low_or


def _bits32(t: torch.Tensor) -> torch.Tensor:
    if t.element_size() != 4:
        raise ValueError(f"payloads must be 32-bit, got {t.dtype}")
    return t if t.dtype == I32 else t.view(I32)


# --------------------------------------------------------------------------
# K1 / K5: stable per-block compaction
# --------------------------------------------------------------------------

def pack_blocks_plain(key, cols, thresh: int, block: int, carry_key: bool):
    """Per-block stable compaction: rows whose u32 key < thresh move to the
    block's front in order; the tail is (key 0xFFFFFFFF, payload 0).
    Returns (packed key or None, packed cols, counts [G] int32)."""
    N = key.shape[0]
    G = N // block
    if G * block != N:
        raise ValueError(f"{N} rows are not a multiple of block {block}")
    valid = (from_bits(key) < (int(thresh) & MASK32)).view(G, block)
    counts = valid.sum(dim=1, dtype=I32)
    rank = torch.cumsum(valid.to(I64), dim=1) - 1
    dst = (torch.arange(G, device=key.device)[:, None] * block + rank)[valid]

    def route(x, fill):
        out = torch.full((N,), fill, dtype=x.dtype, device=x.device)
        out[dst] = x.view(G, block)[valid]
        return out

    pk = route(key, _KEY_TAIL) if carry_key else None
    return pk, [route(c, 0) for c in cols], counts


def _pack_blocks_cuda(key, cols, thresh: int, block: int, carry_key: bool):
    N = key.shape[0]
    G = N // block
    if G * block != N or block % 1024:
        raise ValueError(f"pack needs N % block == 0 and block % 1024 == 0 "
                         f"(N={N}, block={block})")
    if not 1 <= len(cols) <= 3:
        raise ValueError("pack takes 1 to 3 payload columns")
    key = key.contiguous()
    cols = [_bits32(c.contiguous()) for c in cols]
    outs = [torch.empty_like(c) for c in cols]
    pk = torch.empty_like(key) if carry_key else None
    counts = torch.empty(G, dtype=I32, device=key.device)
    p = [build.ptr(c) for c in cols] + [0] * (3 - len(cols))
    o = [build.ptr(c) for c in outs] + [0] * (3 - len(outs))
    lib = build.lib()
    with torch.cuda.device(key.device):
        code = lib.iht_pack_blocks(
            key.data_ptr(), p[0], p[1], p[2], len(cols), int(thresh) & MASK32, G,
            block, build.ptr(pk), o[0], o[1], o[2], counts.data_ptr(),
            build.stream_ptr(key.device),
        )
    build.check(code, "pack_blocks")
    return pk, outs, counts


def pack_payload_blocks_plain(key, cols, thresh: int, block: int):
    """K5 plain twin: (packed cols, counts); the key only masks."""
    _, pcols, counts = pack_blocks_plain(key, cols, thresh, block, carry_key=False)
    return pcols, counts


def pack_payload_blocks(key, cols, thresh: int, block: int):
    """K5 wrapper: plain twin on the CPU, CUDA kernel on a CUDA tensor."""
    if key.device.type == "cpu":
        return pack_payload_blocks_plain(key, cols, thresh, block)
    _, outs, counts = _pack_blocks_cuda(key, cols, thresh, block, carry_key=False)
    build.LAUNCHES["pack_payload_blocks"] += 1
    return [o.view(c.dtype) for o, c in zip(outs, cols)], counts


def pack_valid_blocks_plain(key, cols, thresh: int, block: int):
    """K6 plain version: per block of `block` rows, the rows whose u32 key is
    below `thresh` move to the block's front in their original order, with
    the key and every payload column; the rest of the block is (key
    0xFFFFFFFF, payload 0). Returns (packed key, packed cols, counts [G]
    int32)."""
    pk, pcols, counts = pack_blocks_plain(key, cols, thresh, block, carry_key=True)
    return pk, pcols, counts


def pack_valid_blocks(key, cols, thresh: int, block: int):
    """K6 wrapper (the fold prepass of ``accum.compact_valid``): one or two
    payload columns of any 32-bit dtypes, a general threshold. The plain
    version on the CPU, the CUDA kernel on a CUDA tensor.

    The TPU kernel routes rows by a butterfly of lane rolls, since Mosaic has
    no scatter; that routing is dropped. Here the rank of a row is a
    block-wide exclusive prefix sum of the valid flags (warp ballots, then a
    scan of the warp totals in shared memory) and each kept row is one
    indexed write. The values (order, tail, counts) are the TPU kernel's."""
    if key.device.type == "cpu":
        return pack_valid_blocks_plain(key, cols, thresh, block)
    if not 1 <= len(cols) <= 2:
        raise ValueError("pack_valid_blocks takes 1 or 2 payload columns")
    pk, outs, counts = _pack_blocks_cuda(key, cols, thresh, block, carry_key=True)
    build.LAUNCHES["pack_valid_blocks"] += 1
    return pk, [o.view(c.dtype) for o, c in zip(outs, cols)], counts


def pack_rows(key, w, block: int):
    """K1 wrapper as the trace path uses it: keep rows with key !=
    0xFFFFFFFF, carry the key and one float payload."""
    if key.device.type == "cpu":
        pk, (pw,), counts = pack_blocks_plain(key, [w], MASK32, block, True)
        return pk, pw, counts
    pk, (pw,), counts = _pack_blocks_cuda(key, [w], MASK32, block, True)
    build.LAUNCHES["pack_rows"] += 1
    return pk, pw.view(w.dtype), counts


def pack_rows_plain(key, w, block: int):
    pk, (pw,), counts = pack_blocks_plain(key, [w], MASK32, block, True)
    return pk, pw, counts


# --------------------------------------------------------------------------
# K3 / K3' / P2: block scatter
# --------------------------------------------------------------------------

def scatter_blocks_multi_plain(vals_list, start, out_len: int, block: int,
                               marker_tail=None):
    """Forward-overwrite block scatter as a gather: out[p] = vals[g][p -
    start[g]] for the last block g with start[g] <= p when p - start[g] <
    block, else 0. start: [G] int32, nondecreasing. Then, with marker_tail
    (t0, tlen, shift, low_or), channel 0 takes ((i << shift) | low_or) at
    t0 + i for i < tlen."""
    if marker_tail is not None:
        t0, tlen, shift, low_or = _check_marker_tail(marker_tail, out_len)
    G, blk = vals_list[0].shape
    dev = vals_list[0].device
    p = torch.arange(out_len, device=dev, dtype=I64)
    st = start.to(I64)
    g = torch.searchsorted(st, p, right=True) - 1
    gc = torch.clamp_min(g, 0)
    off = p - st[gc]
    ok = (g >= 0) & (off < blk)
    src = gc * blk + torch.where(ok, off, 0)
    outs = []
    for v in vals_list:
        flat = v.reshape(-1)
        outs.append(torch.where(ok, flat[src], torch.zeros((), dtype=v.dtype, device=dev)))
    if marker_tail is not None and tlen:
        i = torch.arange(tlen, device=dev, dtype=I64)
        marks = to_bits((i << shift) | low_or)
        outs[0] = outs[0].clone()
        outs[0][t0:t0 + tlen] = marks.view(outs[0].dtype)
    return outs


def _scatter_blocks_cuda(vals_list, start, out_len: int, block: int,
                         marker_tail=None, perm=None):
    """Launch scatter_tiles_kernel once for every column on CUDA tensors (no
    launch count: K3, K3' and P2 count their own). perm: [G, blk] int32,
    the source row inside its block of each block row, or None."""
    dev = vals_list[0].device
    has_tail, t0, tlen, shift, low_or = 0, 0, 0, 0, 0
    if marker_tail is not None:
        t0, tlen, shift, low_or = _check_marker_tail(marker_tail, out_len)
        has_tail = 1
    if not 1 <= len(vals_list) <= MAX_SCATTER_COLS:
        raise ValueError(f"the block scatter takes 1 to {MAX_SCATTER_COLS} columns")
    G, blk = vals_list[0].shape
    if any(v.shape != (G, blk) for v in vals_list) or start.shape != (G,):
        raise ValueError(f"the block scatter takes columns [G, blk] and start [G], got "
                         f"{[tuple(v.shape) for v in vals_list]} and {tuple(start.shape)}")
    if perm is not None:
        if perm.shape != (G, blk) or perm.dtype != I32:
            raise ValueError(f"perm must be int32 [{G}, {blk}]")
        perm = perm.contiguous()
    vals = [_bits32(v.contiguous()) for v in vals_list]
    start = start.to(I32).contiguous()
    outs = [torch.empty(out_len, dtype=I32, device=dev) for _ in vals]
    lib = build.lib()
    with torch.cuda.device(dev):
        code = lib.iht_scatter_blocks(
            build.ptr_array(vals), len(vals), build.ptr(perm), start.data_ptr(), G, blk,
            out_len, build.ptr_array(outs), has_tail, t0, tlen, shift, low_or,
            build.stream_ptr(dev),
        )
    build.check(code, "scatter_blocks")
    return [o.view(v.dtype) for o, v in zip(outs, vals_list)]


def scatter_blocks_multi(vals_list, start, out_len: int, block: int,
                         marker_tail=None):
    """K3 wrapper (the payloads share one start vector): plain twin on the
    CPU, the block scatter kernel on a CUDA tensor."""
    if vals_list[0].device.type == "cpu":
        return scatter_blocks_multi_plain(vals_list, start, out_len, block, marker_tail)
    outs = _scatter_blocks_cuda(vals_list, start, out_len, block, marker_tail)
    build.LAUNCHES["scatter_blocks_multi"] += 1
    return outs


def scatter_blocks_plain(vals_list, start, out_len: int, block: int, perm=None):
    """K3' plain twin for a list of columns [G, blk]: each column, gathered
    inside its blocks by perm first when given (vals[g, perm[g, j]] at
    [g, j]), through the forward-overwrite scatter."""
    if perm is not None:
        vals_list = [v.gather(1, perm.to(I64)) for v in vals_list]
    return scatter_blocks_multi_plain(list(vals_list), start, out_len, block)


def scatter_blocks(vals_list, start, out_len: int, block: int, perm=None):
    """K3' wrapper: every column of the call, with the optional in-block
    permutation, in one launch of the block scatter kernel on CUDA tensors
    (its plain twin on the CPU)."""
    if vals_list[0].device.type == "cpu":
        return scatter_blocks_plain(vals_list, start, out_len, block, perm)
    outs = _scatter_blocks_cuda(vals_list, start, out_len, block, perm=perm)
    build.LAUNCHES["scatter_blocks"] += 1
    return outs


# --------------------------------------------------------------------------
# K6 + K3': the one-pass compaction of compact_valid
# --------------------------------------------------------------------------

def compact_rows_plain(key, cols, keep: int, block: int):
    """compact_valid as the JAX package composes it: rows padded to the
    block, K6 (pack_valid_blocks_plain, every key but 0xFFFFFFFF kept), then
    the block scatter of the key and each column to the exclusive sum of the
    counts, cut to `keep`. Returns ((key', cols'...), n_valid int64): the
    kept rows in their original order, then up to `block` rows past the last
    block's first kept row of (0xFFFFFFFF, 0), then (0, 0)."""
    key, cols = pad_rows(key, cols, block)
    G = key.shape[0] // block
    pk, pcols, counts = pack_valid_blocks_plain(key, cols, MASK32, block)
    outs = scatter_blocks_plain([x.view(G, block) for x in (pk, *pcols)],
                                exclusive_starts(counts), keep, block)
    return tuple(outs), counts.to(I64).sum()


def _compact_rows_cuda(key, cols, keep: int, block: int):
    if block != COMPACT_BLOCK:
        raise ValueError(f"compact_rows runs on blocks of {COMPACT_BLOCK} rows, not {block}")
    if not 1 <= len(cols) <= 3:
        raise ValueError("compact_rows takes 1 to 3 payload columns")
    n = key.shape[0]
    if key.dim() != 1 or any(c.shape != (n,) for c in cols) or not 0 <= n < 1 << 31:
        raise ValueError(f"compact_rows takes a key and columns of one length below 2^31, "
                         f"got {tuple(key.shape)} and {[tuple(c.shape) for c in cols]}")
    dev = key.device
    key = _bits32(key.contiguous())
    vals = [_bits32(c.contiguous()) for c in cols]
    key_out = torch.empty(keep, dtype=I32, device=dev)
    outs = [torch.empty(keep, dtype=I32, device=dev) for _ in vals]
    # Zeroed: the tile counter, the last tile's word, the total, one word a tile.
    state = torch.zeros(3 + -(-n // block), dtype=I64, device=dev)
    vec = all(t.data_ptr() % 16 == 0 for t in (key, *vals))
    lib = build.lib()
    with torch.cuda.device(dev):
        code = lib.iht_compact_rows(
            key.data_ptr(), build.ptr_array(vals), len(vals), n, keep, key_out.data_ptr(),
            build.ptr_array(outs), state.data_ptr(), int(vec), build.stream_ptr(dev),
        )
    build.check(code, "compact_rows")
    return (key_out, *[o.view(c.dtype) for o, c in zip(outs, cols)]), state[2]


def compact_rows(key, cols, keep: int, block: int):
    """compact_valid in one launch (K6 and K3' fused) on CUDA tensors: 1 to 3
    payload columns of any 32-bit dtypes, rows of any count (no padding
    copy: rows past the last are dead). The plain twin on the CPU. The
    values equal compact_rows_plain's for any input, kept rows beyond
    `keep` included."""
    if key.device.type == "cpu":
        return compact_rows_plain(key, cols, keep, block)
    out = _compact_rows_cuda(key, cols, keep, block)
    build.LAUNCHES["compact_rows"] += 1
    return out
