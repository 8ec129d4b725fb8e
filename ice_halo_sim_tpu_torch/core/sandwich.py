"""The sandwich fold: a scatter-add of contribution rows into a tile of
listed pixel chunks, no sort (port of ``ice_halo_sim_tpu.core.pallas_sandwich``:
K7 ``_kernel_lane`` and K8 ``_kernel``).

Binning N spectral contribution rows into pixels splits the pixel id as
p = chunk * NLO + lo (NLO = 128). For a LIST of chunks ``cl[0..NC)`` (any
subset of the image's chunks, in any order):

    out[k, c*NLO + lo] = sum_r [chunk_r == cl[k]] * vals[r, c] * [lo_r == lo]

with vals[r, c] = tbl[wl_r, c] * w_r rebuilt from the wavelength-pool table,
so a pass reads (pix, w, wl_idx) per row, as the sort fold does. ``vals`` is
rounded to bf16 (about 0.4% per row, unbiased), or split into two bf16 terms
(``precise``, about 2^-16 relative), as the TPU kernels' one-hot product
rounds it. Sums are float32.

The cost grows with NC, so the TPU engine runs a cascade of passes: the
chunks that hold most rows over all rows, then the remaining chunks over only
the rows the earlier passes missed. The port's engine folds by sort only (on
the H100 the cascade never beat it by more than its spread), so these kernels
are on no path of the engine; the tests and ``chip_smoke.py`` hold them
against their plain versions.

``sandwich_pass`` launches the CUDA kernels of csrc/sandwich.cu on CUDA
tensors and runs ``sandwich_pass_plain`` on CPU tensors; it never falls back.
Both kernels add the rows into a [S, C*128] float32 slice of the tile held in
shared memory (S = 384 / C list entries, ``list_block``), 1024 rows at a time
as a reduction by key (a stable sort by cell, a segmented scan, one add per
cell), so the bits do not depend on the schedule:
  - ``layout="lane"``, K7: output-stationary. The grid is (row splits,
    slices of the list); every block streams its split's rows and finds each
    row's slot by a binary search of its sorted slice, so a row is read once
    per slice;
  - ``layout="sublane"``, K8: row-stationary. The rows are grouped by slice
    first (a sort of the list, a count per tile of 1024 rows and slice, a
    scan, a stable scatter); then each block reads only its slice's rows.
A pass with several row splits adds their partial tiles in split order
(``_splits`` chooses the splits). The plain version repeats the kernels'
rounding (float32 product, bf16 terms) and sums in float64, rounded once;
``slice_slots_plain`` is the plain form of the kernels' slot search.

Not carried over from the TPU module, because they exist for Mosaic's tiling
and VMEM: ``prep_rows`` with the [1, N] / [N, 1] relayouts, ``DEFAULT_RB``
(the rows of a grid step) and the ``SUB_CHUNKS`` loop over slices of a wide
list. The wrapper takes flat [N] operands of any length.
"""

from __future__ import annotations

import numpy as np
import torch

from ice_halo_sim_tpu_torch.core.bits import F32, I32, I64
from ice_halo_sim_tpu_torch.kernels import build

NLO = 128               # lo width; chunk = pix // NLO
MAX_POOL = 128          # wavelength-pool entries the kernels' table holds
_PAD_ID = -0x40000000   # what a negative list id becomes: equals no row's chunk
_SLICE_CELLS = 384      # list entries * channels of a block's tile slice (kCells)
_SLAB = 1024            # rows a thread block stages per step (kSlab)
_GROUP_TILE = 1024      # K8: rows per counting block (kGroupTile)
_MAX_SLICES = 64        # K8: slices of the list (kMaxSlices)
_MAX_SORTED = 8192      # K8: list entries its one-block sort takes (kMaxSorted)

# The kernel a pass launches when its caller names no layout: "lane" is K7,
# "sublane" is K8, the A/B form (the TPU module's LAYOUT).
LAYOUT = "lane"


def _bf16_terms(vals, precise: bool):
    """The bf16 term(s) the product multiplies, as float32."""
    hi = vals.to(torch.bfloat16).to(F32)
    if not precise:
        return [hi]
    return [hi, (vals - hi).to(torch.bfloat16).to(F32)]


def _list_slots(chunk_list, chunk):
    """Per row: (index of its chunk in the list, whether it is listed).
    Negative list ids match nothing."""
    cl = chunk_list.to(I64)
    cl = torch.where(cl < 0, _PAD_ID, cl)
    sorted_cl, order = torch.sort(cl)
    pos = torch.clamp_max(torch.searchsorted(sorted_cl, chunk), cl.shape[0] - 1)
    return order[pos], sorted_cl[pos] == chunk


def sandwich_pass_plain(tile, chunk_list, pix, w, wl_idx, tbl, *, k_pool: int,
                        precise: bool = False, layout: str | None = None):
    """Plain version of K7 and K8 (any device): the kernels' function with
    their rounding. Returns (tile + contributions, matched [N] int32)."""
    nc, cw = tile.shape
    c_out = cw // NLO
    if cw != c_out * NLO or tuple(tbl.shape) != (k_pool, c_out):
        raise ValueError(f"tile {tuple(tile.shape)} / table {tuple(tbl.shape)} do not fit")
    pix = pix.to(I64)
    vals = tbl.to(F32)[wl_idx.to(I64)] * w.to(F32)[:, None]          # [N, C] float32
    chunk = torch.div(pix, NLO, rounding_mode="floor")
    lo = pix - chunk * NLO
    slot, hit = _list_slots(chunk_list, chunk)
    matched = hit.to(I32)
    add = torch.zeros(nc * cw, dtype=torch.float64, device=tile.device)
    base = (slot * cw + lo)[hit]
    for term in _bf16_terms(vals, precise):
        for c in range(c_out):
            add.index_add_(0, base + c * NLO, term[hit, c].to(torch.float64))
    return (tile.to(torch.float64) + add.view(nc, cw)).to(F32), matched


def list_block(c_out: int) -> int:
    """List entries in one block's tile slice: 128 at three channels, 384
    for a count tile (192 KB of shared memory either way)."""
    return _SLICE_CELLS // c_out


def _splits(n_rows: int, nc: int, c_out: int, sms: int):
    """(row splits, rows per split, padded list length) of one launch. The
    grid is (splits, slices of the list) at one block per multiprocessor:
    as many splits as fill the card once (at least one, at most one per slab
    of rows). Filling the card comes first: where the list has few slices the
    partial tiles (splits x padded list x C*128 floats) may outgrow the rows'
    own 12 bytes each. K8 cuts each slice's grouped rows into as many equal
    parts."""
    s = list_block(c_out)
    n_slices = -(-nc // s)
    n_slabs = -(-n_rows // _SLAB)
    want = max(1, min(n_slabs, sms // n_slices))
    rows_per_split = -(-n_slabs // want) * _SLAB
    return -(-n_rows // rows_per_split), rows_per_split, n_slices * s


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _sublane_scratch_ints(n_rows: int, nc: int, nc_pad: int, c_out: int) -> int:
    """int32 scratch of K8 and P1 (csrc/sandwich.cu run_sublane): the sorted
    list ids and positions, the rows' list positions, the counts per (tile,
    slice) and the grouped key, weight and pool index, each rounded up to 4."""
    def r4(x):
        return -(-x // 4) * 4
    n_tiles = -(-n_rows // _GROUP_TILE)
    m = n_tiles * (nc_pad // list_block(c_out))
    return 2 * r4(_pow2_at_least(nc)) + 4 * r4(n_rows) + r4(m + 1)


def slice_slots_plain(chunk_list, chunk, c_out: int):
    """Plain form of the kernels' slot search: per row its list position k
    (-1: not listed), found as K7 finds it, by a binary search of the sorted
    ids of each slice of list_block(c_out) entries (negative ids padded)."""
    s = list_block(c_out)
    cl = torch.where(chunk_list.to(I64) < 0, _PAD_ID, chunk_list.to(I64))
    chunk = chunk.to(I64)
    pos = torch.full(chunk.shape, -1, dtype=I64, device=chunk.device)
    for m0 in range(0, cl.shape[0], s):
        ids, order = torch.sort(cl[m0:m0 + s])
        at = torch.clamp_max(torch.searchsorted(ids, chunk), ids.shape[0] - 1)
        pos = torch.where(ids[at] == chunk, order[at] + m0, pos)
    return pos


def _aligned(x):
    """x, or a copy where its data is not 16-byte aligned (the kernels load
    four rows at a time)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _check_rows(pix, w, wl_idx, tbl, k_pool: int, c_out: int):
    dev = pix.device
    n = pix.shape[0]
    if c_out not in (1, 3):
        raise ValueError(f"the sandwich kernels take 1 or 3 channels, got {c_out}")
    if not 1 <= k_pool <= MAX_POOL:
        raise ValueError(f"k_pool must be in [1, {MAX_POOL}], got {k_pool}")
    if tuple(tbl.shape) != (k_pool, c_out):
        raise ValueError(f"table must be [{k_pool}, {c_out}], got {tuple(tbl.shape)}")
    if pix.dim() != 1 or w.shape != (n,) or wl_idx.shape != (n,):
        raise ValueError("pix, w and wl_idx must be flat and of one length")
    if w.device != dev or wl_idx.device != dev or tbl.device != dev:
        raise ValueError("pix, w, wl_idx and the table must lie on one device")
    return (pix.to(I32).contiguous(), w.to(F32).contiguous(),
            wl_idx.to(I32).contiguous(), tbl.to(F32).contiguous())


def sandwich_pass(tile, chunk_list, pix, w, wl_idx, tbl, *, k_pool: int,
                  precise: bool = False, layout: str | None = None):
    """Accumulate the rows whose chunk (pix // 128) is in `chunk_list`.

    tile:       [NC, C * 128] float32, the running accumulator, one row per
                list entry; C is 3, or 1 for a count tile.
    chunk_list: [NC] int32 chunk ids, unique; a negative id matches nothing.
    pix:        [N] pixel ids; a row whose chunk is not listed (a dead row's
                -1 among them) contributes nothing.
    w:          [N] float32 weights (dead rows: 0).
    wl_idx:     [N] wavelength-pool indices in [0, k_pool).
    tbl:        [k_pool, C] float32 basis of every pool entry.

    Returns (tile + contributions, matched [N] int32); matched[r] = 1 iff
    row r's chunk is listed. The plain version on CPU tensors; on CUDA
    tensors K7 (layout "lane") or K8 ("sublane"), or an error; with no
    layout named, the module's LAYOUT."""
    layout = layout or LAYOUT
    if layout not in ("lane", "sublane"):
        raise ValueError(f"layout must be 'lane' or 'sublane', got {layout!r}")
    if tile.device.type == "cpu":
        return sandwich_pass_plain(tile, chunk_list, pix, w, wl_idx, tbl, k_pool=k_pool,
                                   precise=precise)
    nc, cw = tile.shape
    c_out = cw // NLO
    if cw != c_out * NLO or tile.dtype != F32:
        raise ValueError(f"tile must be float32 [NC, C * {NLO}], got {tuple(tile.shape)}")
    if chunk_list.shape != (nc,) or chunk_list.device != tile.device or \
            pix.device != tile.device:
        raise ValueError("the chunk list must be [NC], on the tile's device like the rows")
    if layout == "sublane" and nc > _MAX_SORTED:
        raise ValueError(f"K8 takes a list of at most {_MAX_SORTED} chunks, got {nc}")
    pix, w, wl_idx, tbl = _check_rows(pix, w, wl_idx, tbl, k_pool, c_out)
    lib = build.lib()
    dev = tile.device
    n = pix.shape[0]
    matched = torch.zeros(n, dtype=I32, device=dev)
    if n == 0:
        return tile.clone(), matched
    tile = tile.contiguous()
    cl = chunk_list.to(I32).contiguous()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split, rows_per_split, nc_pad = _splits(n, nc, c_out, sms)
    partial = torch.empty((n_split, nc_pad, cw) if n_split > 1 else (4,), dtype=F32, device=dev)
    out = torch.empty_like(tile)
    pix, w, wl_idx = _aligned(pix), _aligned(w), _aligned(wl_idx)
    rows = (pix.data_ptr(), w.data_ptr(), wl_idx.data_ptr(), tbl.data_ptr(), cl.data_ptr(),
            n, nc, c_out, k_pool, int(bool(precise)), n_split)
    if layout == "lane":
        with torch.cuda.device(dev):
            code = lib.iht_sandwich_lane(
                *rows, rows_per_split, nc_pad, tile.data_ptr(), partial.data_ptr(),
                matched.data_ptr(), out.data_ptr(), build.stream_ptr(dev))
        build.check(code, "sandwich_lane")
        build.LAUNCHES["sandwich_lane"] += 1
    else:
        n_ints = _sublane_scratch_ints(n, nc, nc_pad, c_out)
        scratch = torch.empty(n_ints, dtype=I32, device=dev)
        with torch.cuda.device(dev):
            code = lib.iht_sandwich_sublane(
                *rows, nc_pad, tile.data_ptr(), partial.data_ptr(), matched.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), n_ints, build.stream_ptr(dev))
        build.check(code, "sandwich_sublane")
        build.LAUNCHES["sandwich_sublane"] += 1
    return out, matched


def assemble_image(tiles_and_lists, n_pixels: int, c_out: int) -> np.ndarray:
    """Host side: the dense [P, C] float64 image from (tile [NC, C*128],
    chunk list [NC]) pairs. A chunk listed in several tiles sums."""
    n_chunks = -(-n_pixels // NLO)
    img = np.zeros((n_chunks, NLO, c_out), np.float64)
    for tile, cl in tiles_and_lists:
        t = _host(tile).astype(np.float64).reshape(-1, c_out, NLO).transpose(0, 2, 1)
        cl = _host(cl).astype(np.int64)
        ok = (cl >= 0) & (cl < n_chunks)
        np.add.at(img, cl[ok], t[ok])
    return img.reshape(n_chunks * NLO, c_out)[:n_pixels]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
