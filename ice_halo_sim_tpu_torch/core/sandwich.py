"""The sandwich fold: scatter-add as a one-hot product, no sort (port of
``ice_halo_sim_tpu.core.pallas_sandwich``: K7 ``_kernel_lane`` and K8
``_kernel``).

Binning N spectral contribution rows into pixels splits the pixel id as
p = chunk * NLO + lo (NLO = 128). For a LIST of chunks ``cl[0..NC)`` (any
subset of the image's chunks, in any order):

    out[k, c*NLO + lo] = sum_r [chunk_r == cl[k]] * vals[r, c] * [lo_r == lo]

with vals[r, c] = tbl[wl_r, c] * w_r rebuilt from the wavelength-pool table,
so a pass reads (pix, w, wl_idx) per row, as the sort fold does. The one-hot
factors are exact in bf16; ``vals`` is rounded to bf16 (about 0.4% per row,
unbiased), or split into two bf16 terms (``precise``, about 2^-16 relative)
at twice the product's cost. Sums are float32.

The cost grows with NC, so the engine runs a cascade of passes
(engine/simulator.py): the chunks that hold most rows over all rows, then the
remaining chunks over only the rows the earlier passes missed, compacted
first. A row matches exactly one list across a cascade whose last list covers
the image, so the result is exact for any split of the chunks; the lists
change the speed, never the image.

``sandwich_pass`` launches the CUDA kernels of csrc/sandwich.cu on CUDA
tensors (``layout="lane"``: K7, ``"sublane"``: K8, the A/B form) and runs
``sandwich_pass_plain`` on CPU tensors; it never falls back. The plain
version repeats the kernels' rounding (float32 product, bf16 terms) and sums
in float64, rounded once.

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
from ice_halo_sim_tpu_torch.utils import env_knobs

NLO = 128               # lo width; chunk = pix // NLO
MAX_POOL = 128          # wavelength-pool entries the kernels' table holds
_PAD_ID = -0x40000000   # what a negative list id becomes: equals no row's chunk
_LIST_BLOCK = 64        # list entries per thread block (csrc/sandwich.cu kBM)
_SLAB = 256             # rows a thread block stages per step (kSlab)

# The kernel a pass launches when its caller names no layout: "lane" is K7,
# "sublane" is K8, the A/B form (the TPU module's LAYOUT). The engine names
# none, so setting this before a run sends the whole fold through K8.
LAYOUT = "lane"

# Test hook: treat the sandwich fold as available on CPU tensors, where the
# plain version runs (the counterpart of the TPU module's INTERPRET).
CPU_TEST_HOOK = False


def available(device) -> bool:
    """Whether an engine on `device` may fold by sandwich: not switched off
    (IHT_PALLAS / IHT_SANDWICH), and a CUDA device; on the CPU only under
    the test hook."""
    if str(env_knobs.get("IHT_PALLAS", "1")).lower() in ("0", "off"):
        return False
    if str(env_knobs.get("IHT_SANDWICH", "1")).lower() in ("0", "off"):
        return False
    return CPU_TEST_HOOK or torch.device(device).type == "cuda"


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


def _splits(n_rows: int, nc: int, device):
    """(row splits, rows per split, padded list length) of one launch: two
    thread blocks per multiprocessor over the (split, list slice) grid."""
    m_tiles = -(-nc // _LIST_BLOCK)
    n_slabs = -(-n_rows // _SLAB)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, min(n_slabs, (2 * sms) // m_tiles))
    rows_per_split = -(-n_slabs // want) * _SLAB
    return -(-n_rows // rows_per_split), rows_per_split, m_tiles * _LIST_BLOCK


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
    pix, w, wl_idx, tbl = _check_rows(pix, w, wl_idx, tbl, k_pool, c_out)
    lib = build.lib()
    dev = tile.device
    n = pix.shape[0]
    matched = torch.zeros(n, dtype=I32, device=dev)
    if n == 0:
        return tile.clone(), matched
    tile = tile.contiguous()
    cl = chunk_list.to(I32).contiguous()
    n_split, rows_per_split, nc_pad = _splits(n, nc, dev)
    partial = torch.empty((n_split, nc_pad, cw), dtype=F32, device=dev)
    out = torch.empty_like(tile)
    args = (
        pix.data_ptr(), w.data_ptr(), wl_idx.data_ptr(), tbl.data_ptr(), cl.data_ptr(),
        n, nc, c_out, k_pool, int(bool(precise)), n_split, rows_per_split, nc_pad,
        tile.data_ptr(), partial.data_ptr(), matched.data_ptr(), out.data_ptr(),
        build.stream_ptr(dev),
    )
    if layout == "lane":
        code = lib.iht_sandwich_lane(*args)
        build.check(code, "sandwich_lane")
        build.LAUNCHES["sandwich_lane"] += 1
    else:
        code = lib.iht_sandwich_sublane(*args)
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
