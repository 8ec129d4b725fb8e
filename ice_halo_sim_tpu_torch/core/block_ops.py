"""Block pack and block scatter (port of ``ice_halo_sim_tpu.core.pallas_ops``:
K1 ``_pack_one_block``, K6 ``pack_valid_blocks``, K5 ``pack_payload_blocks``,
K3 ``scatter_blocks_multi`` and K3' ``scatter_blocks``).

Each function has a plain PyTorch twin (``*_plain``, any device) beside
its wrapper. The wrapper runs the twin for a CPU tensor and the CUDA
kernel (csrc/block_ops.cu) for a CUDA tensor; it never falls back.

Keys are int32 tensors holding u32 bit patterns; payload columns are any
32-bit dtype (the kernels move them as raw bits).
"""

from __future__ import annotations

import torch

from ice_halo_sim_tpu_torch.core.bits import I32, I64, MASK32, from_bits, to_bits
from ice_halo_sim_tpu_torch.kernels import build

_KEY_TAIL = -1  # 0xFFFFFFFF as an int32 bit pattern


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
    code = build.lib().iht_pack_blocks(
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
# K3 / K3': block scatter
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
                         marker_tail=None):
    """Launch scatter_blocks_kernel on CUDA tensors (no launch count: K3 and
    K3' count their own)."""
    dev = vals_list[0].device
    has_tail, t0, tlen, shift, low_or = 0, 0, 0, 0, 0
    if marker_tail is not None:
        t0, tlen, shift, low_or = _check_marker_tail(marker_tail, out_len)
        has_tail = 1
    if not 1 <= len(vals_list) <= 3:
        raise ValueError("scatter takes 1 to 3 payloads")
    G, blk = vals_list[0].shape
    vals = [_bits32(v.contiguous()) for v in vals_list]
    start = start.to(I32).contiguous()
    outs = [torch.empty(out_len, dtype=I32, device=dev) for _ in vals]
    vp = [v.data_ptr() for v in vals] + [0] * (3 - len(vals))
    op = [o.data_ptr() for o in outs] + [0] * (3 - len(outs))
    code = build.lib().iht_scatter_blocks(
        vp[0], vp[1], vp[2], len(vals), start.data_ptr(), G, blk, out_len,
        op[0], op[1], op[2], has_tail, t0, tlen, shift, low_or,
        build.stream_ptr(dev),
    )
    build.check(code, "scatter_blocks")
    return [o.view(v.dtype) for o, v in zip(outs, vals_list)]


def scatter_blocks_multi(vals_list, start, out_len: int, block: int,
                         marker_tail=None):
    """K3 wrapper (1 to 3 payloads sharing one start vector): plain twin on
    the CPU, CUDA kernel on a CUDA tensor."""
    if vals_list[0].device.type == "cpu":
        return scatter_blocks_multi_plain(vals_list, start, out_len, block, marker_tail)
    outs = _scatter_blocks_cuda(vals_list, start, out_len, block, marker_tail)
    build.LAUNCHES["scatter_blocks_multi"] += 1
    return outs


def scatter_blocks_plain(vals, start, out_len: int, block: int):
    """K3' plain twin: scatter_blocks_multi_plain with one payload."""
    return scatter_blocks_multi_plain([vals], start, out_len, block)[0]


def scatter_blocks(vals, start, out_len: int, block: int):
    """K3' wrapper: the K3 kernel with one payload (the TPU VMEM/HBM
    variants are one kernel here), counted on its own."""
    if vals.device.type == "cpu":
        return scatter_blocks_plain(vals, start, out_len, block)
    out = _scatter_blocks_cuda([vals], start, out_len, block)[0]
    build.LAUNCHES["scatter_blocks"] += 1
    return out
