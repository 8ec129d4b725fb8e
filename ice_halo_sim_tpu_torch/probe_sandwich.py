"""Probe: the sandwich scatter-add against index_add_ and the sort fold
(port of ``scripts/probe_sandwich.py``, whose kernel is P1).

    python -m ice_halo_sim_tpu_torch.probe_sandwich

Binning N contribution rows into P pixels as a two-level scatter-add, with
p = hi * 128 + lo:

    out[hi, c*128 + lo] = sum_r [hi_r == hi] * bf16(w_r * tbl[wl_r, c]) * [lo_r == lo]

``sandwich_iota`` is the probe's form of it: the chunk list is 0, 1, ...,
NHI - 1 (``hi_r == k``), there is no ``matched`` output and no padding id. On
CUDA tensors it launches csrc/sandwich.cu's ``iht_sandwich_iota`` (K8 with
the slot computed, not searched: the rows grouped by slice of the image,
then added into shared memory); on CPU tensors its plain version.

On one CUDA device the probe measures, at the TPU probe's row count
(N = 3342336 rows over P = 131072 pixels, K = 64, a quarter of them dead):
  1. ``sandwich_iota`` at NHI = 256 (32768 pixels) and 1024 (the whole
     image), with its bf16 rounding error against an exact float64 bincount;
  2. K7 (``sandwich_pass``, layout "lane") over the 256 chunks that hold most
     rows and over every chunk, beside one ``index_add_`` of the same rows
     into the image;
  3. the port's sort fold (``accum.fold_spectral_keys``) on the same rows.
All times are device time (torch.profiler), printed with the card's name and
power limit; the last line is one JSON object with the times and how they
were taken (``timed_by``).
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from ice_halo_sim_tpu_torch.core import accum, sandwich
from ice_halo_sim_tpu_torch.core.bits import F32, I32
from ice_halo_sim_tpu_torch.kernels import build, kernel_set
from ice_halo_sim_tpu_torch.utils.profiling import device_profile

NLO = sandwich.NLO


def sandwich_iota_plain(pix, w, wl_idx, tbl, *, nhi: int, k_pool: int):
    """Plain version of P1: the [NHI, C*128] tile of the chunks 0..NHI-1."""
    c_out = tbl.shape[1]
    tile = torch.zeros((nhi, c_out * NLO), dtype=F32, device=pix.device)
    cl = torch.arange(nhi, dtype=I32, device=pix.device)
    return sandwich.sandwich_pass_plain(tile, cl, pix, w, wl_idx, tbl, k_pool=k_pool)[0]


def sandwich_iota(pix, w, wl_idx, tbl, *, nhi: int, k_pool: int):
    """P1 wrapper: out[hi, c*128 + lo] over the chunks hi < nhi. pix [N], w
    [N] float32, wl_idx [N] in [0, k_pool), tbl [k_pool, C] with C 1 or 3.
    The plain version on CPU tensors, the CUDA kernel on CUDA tensors."""
    if pix.device.type == "cpu":
        return sandwich_iota_plain(pix, w, wl_idx, tbl, nhi=nhi, k_pool=k_pool)
    if tbl.dim() != 2 or nhi < 1:
        raise ValueError("sandwich_iota takes a [k_pool, C] table and nhi >= 1")
    c_out = tbl.shape[1]
    pix, w, wl_idx, tbl = sandwich._check_rows(pix, w, wl_idx, tbl, k_pool, c_out)
    if nhi > sandwich._MAX_SLICES * sandwich.list_block(c_out):
        raise ValueError(f"sandwich_iota takes at most "
                         f"{sandwich._MAX_SLICES * sandwich.list_block(c_out)} chunks")
    lib = build.lib()
    dev = pix.device
    n = pix.shape[0]
    cw = c_out * NLO
    if n == 0:
        return torch.zeros((nhi, cw), dtype=F32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split, _rows_per_split, nc_pad = sandwich._splits(n, nhi, c_out, sms)
    partial = torch.empty((n_split, nc_pad, cw) if n_split > 1 else (4,), dtype=F32, device=dev)
    out = torch.empty((nhi, cw), dtype=F32, device=dev)
    n_ints = sandwich._sublane_scratch_ints(n, nhi, nc_pad, c_out)
    scratch = torch.empty(n_ints, dtype=I32, device=dev)
    with torch.cuda.device(dev):
        code = lib.iht_sandwich_iota(
            pix.data_ptr(), w.data_ptr(), wl_idx.data_ptr(), tbl.data_ptr(), n, nhi, c_out,
            k_pool, n_split, nc_pad, partial.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            n_ints, build.stream_ptr(dev),
        )
    build.check(code, "sandwich_iota")
    build.LAUNCHES["sandwich_iota"] += 1
    return out


# How each device_ms call so far took its time, in order: "profiler" or "cuda
# events". A caller that records a time drains the list (timed_by) into the
# record, so that a number never loses the yardstick it was taken with.
_METHODS: list = []


def timed_by() -> str:
    """The method behind every device_ms time since the last call of this
    function: "profiler", or "cuda events" if any of them fell back."""
    fell_back = "cuda events" in _METHODS
    _METHODS.clear()
    return "cuda events" if fell_back else "profiler"


def device_ms(fn, reps: int = 10) -> float:
    """Device milliseconds per call of fn: the CUDA time of every kernel, copy
    and memset that `reps` calls put on the card (torch.profiler), over reps,
    after one call outside the window (utils/profiling.py: `warm`).
    Now and then the profiler returns no device event at all; the window is
    then profiled twice more, and after that timed with CUDA events around
    the calls (which also count the gaps the host leaves between short
    kernels). `timed_by` says which of the two it was."""
    for _attempt in range(3):
        with device_profile(warm=fn) as win:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        if not win.empty:
            _METHODS.append("profiler")
            return win.device_us / 1e3 / reps
    print("device_ms: the profiler recorded no device time; timing with CUDA events",
          flush=True)
    _METHODS.append("cuda events")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def probe_rows(n: int, n_pixels: int, k_pool: int, seed: int = 0, dead_frac: float = 0.25):
    """The TPU probe's rows as numpy: pixels from a Gaussian around 0.4 P
    (a ring-like concentration), a quarter dead (pix -1, w 0)."""
    rng = np.random.default_rng(seed)
    pix = (rng.normal(0.4, 0.18, n) * n_pixels).astype(np.int64)
    dead = rng.random(n) < dead_frac
    pix[dead] = -1
    pix = np.clip(pix, -1, n_pixels - 1).astype(np.int32)
    w = rng.random(n).astype(np.float32) * 0.9 + 0.1
    w[dead] = 0.0
    wl = rng.integers(0, k_pool, n).astype(np.int32)
    tbl = rng.random((k_pool, 3)).astype(np.float32)
    return pix, w, wl, tbl


def bincount_image(pix, w, wl, tbl, n_pixels: int) -> np.ndarray:
    """Exact float64 reference image [P, C]."""
    vals = tbl[wl].astype(np.float64) * w[:, None].astype(np.float64)
    live = (pix >= 0) & (pix < n_pixels)
    return np.stack([np.bincount(pix[live], weights=vals[live][:, c], minlength=n_pixels)
                     for c in range(tbl.shape[1])], axis=1)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_sandwich: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    P, K, N = 512 * 256, 64, 3_342_336
    pix_np, w_np, wl_np, tbl_np = probe_rows(N, P, K)
    pix, w, wl, tbl = (torch.as_tensor(x).to(dev) for x in (pix_np, w_np, wl_np, tbl_np))
    img_ref = bincount_image(pix_np, w_np, wl_np, tbl_np, P)

    for nhi in (256, 1024):
        out = sandwich_iota(pix, w, wl, tbl, nhi=nhi, k_pool=K)
        ms = device_ms(lambda: sandwich_iota(pix, w, wl, tbl, nhi=nhi, k_pool=K))
        img = sandwich.assemble_image([(out, np.arange(nhi))], nhi * NLO, 3)
        ref = img_ref[:nhi * NLO]
        err = np.abs(img - ref).sum() / max(ref.sum(), 1e-9)
        print(f"sandwich_iota NHI={nhi:5d}: {ms:8.4f} ms  relL1={err:.2e}", flush=True)

    times = {}
    nc_all = P // NLO
    chunk = torch.div(pix, NLO, rounding_mode="floor")
    top = torch.argsort(torch.bincount(chunk[chunk >= 0], minlength=nc_all), descending=True)
    for nc in (256, nc_all):
        cl = (torch.sort(top[:nc])[0].to(I32) if nc < nc_all
              else torch.arange(nc_all, dtype=I32, device=dev))
        tile = torch.zeros((nc, 3 * NLO), dtype=F32, device=dev)
        times[f"k7_nc{nc}"] = device_ms(
            lambda: sandwich.sandwich_pass(tile, cl, pix, w, wl, tbl, k_pool=K))
    # A dead row adds its zero to a pixel of its own, not to one pixel on
    # which a quarter of the rows' atomic adds would queue.
    idx = torch.where(pix >= 0, pix.long(), torch.arange(N, device=dev) % P)
    vals = tbl[wl.long()] * w[:, None]
    image = torch.zeros((P, 3), dtype=F32, device=dev)
    times["index_add"] = device_ms(lambda: image.index_add_(0, idx, vals))
    print(f"K7 lane: NC 256 {times['k7_nc256']:8.4f} ms, NC {nc_all} "
          f"{times[f'k7_nc{nc_all}']:8.4f} ms; index_add_ {times['index_add']:8.4f} ms",
          flush=True)

    key, wz = accum.pack_spectral_keys(pix, w, wl, P, K)
    acc0 = torch.zeros((P, 3), dtype=F32, device=dev)
    ks = kernel_set("cuda")
    times["sort_fold"] = device_ms(lambda: accum.fold_spectral_keys(acc0, key, wz, K, tbl, ks))
    print(f"fold_spectral_keys (sort):  {times['sort_fold']:8.4f} ms", flush=True)
    print(json.dumps({"card": card, "rows": N, "pixels": P, "ms": times,
                      "timed_by": timed_by()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
