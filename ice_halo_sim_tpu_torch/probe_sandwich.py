"""Probe: the sandwich scatter-add against the sort fold, and the constants
of the engine's fold dispatch (port of ``scripts/probe_sandwich.py``, whose
kernel is P1).

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
  2. the port's sort fold (``accum.fold_spectral_keys``) on the same rows;
  3. the constants of ``Engine._sandwich_plan_levels`` and
     ``_sandwich_recalibrate``: K7 (``sandwich_pass``, layout "lane") per row
     and per row and listed chunk from its times at NC = 256 and 1024,
     ``compact_valid`` (one launch of ``block_ops.compact_rows``) per input
     row, and the sort fold's fixed and per-row parts from two row counts;
     then the per-row cost of a
     level's decode, routing and torch glue, ``_C_PREP``, fitted to the
     engine's own sandwich fold on three scenes (``fold_prep``; the probe's
     own decode-and-routing figure stays beside it as ``_C_PREP_probe``).
All times are device time (torch.profiler), printed with the card's name and
power limit; the last line is one JSON object with the constants in ms, the
times they were computed from and how those were taken (``timed_by``).
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from ice_halo_sim_tpu_torch.core import accum, sandwich
from ice_halo_sim_tpu_torch.core.bits import F32, I32, from_bits
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


def measure_constants(dev, pix, w, wl, tbl, n_pixels: int, k_pool: int) -> dict:
    """The fold dispatch's cost constants, in ms, from this card, and the
    times they come from."""
    ks = kernel_set("cuda")
    n = pix.shape[0]
    nc_all = n_pixels // NLO
    chunk = torch.div(pix, NLO, rounding_mode="floor")
    rows_per_chunk = torch.bincount(chunk[chunk >= 0], minlength=nc_all)
    top = torch.argsort(rows_per_chunk, descending=True)

    def k7(nc):
        cl = torch.sort(top[:nc])[0].to(I32) if nc < nc_all else \
            torch.arange(nc_all, dtype=I32, device=dev)
        tile = torch.zeros((nc, 3 * NLO), dtype=F32, device=dev)
        return device_ms(lambda: sandwich.sandwich_pass(tile, cl, pix, w, wl, tbl,
                                                        k_pool=k_pool))

    t256, t1024 = k7(256), k7(min(1024, nc_all))
    chunkrow = (t1024 - t256) / (n * (min(1024, nc_all) - 256))
    base = t256 / n - 256 * chunkrow

    key, wz = accum.pack_spectral_keys(pix, w, wl, n_pixels, k_pool)
    shift = accum.key_shift(k_pool)
    m = (torch.arange(n, device=dev) % 3 == 0).to(I32)

    def prep():
        kk = from_bits(key)
        p, l = (kk >> shift).to(I32), ((kk >> 1) & (k_pool - 1)).to(I32)
        miss = m == 0
        nk = torch.where(miss & (wz > 0.0), key, -1)
        nw = torch.where(miss, wz, 0.0)
        return p, l, nk, nw, (nw > 0.0).sum()

    t_prep = device_ms(prep)
    live = int((wz > 0.0).sum())
    keep = -(-int(live * 1.06) // accum.BLOCK) * accum.BLOCK
    t_pack = device_ms(lambda: accum.compact_valid(key, [wz], keep, ks))

    acc0 = torch.zeros((n_pixels, 3), dtype=F32, device=dev)

    def sort_fold(rows):
        return device_ms(lambda: accum.fold_spectral_keys(
            acc0, key[:rows], wz[:rows], k_pool, tbl, ks))

    n1, n2 = n // 4, n
    s1, s2 = sort_fold(n1), sort_fold(n2)
    sort_row = (s2 - s1) / (n2 - n1)
    sort_fix = s1 - (n1 + n_pixels) * sort_row
    print(f"K7 lane at N = {n}: NC 256 {t256:.4f} ms, NC {min(1024, nc_all)} {t1024:.4f} ms; "
          f"decode and routing {t_prep:.4f} ms; compact_valid to keep {keep} {t_pack:.4f} ms; "
          f"sort fold {n1} rows {s1:.4f} ms, {n2} rows {s2:.4f} ms", flush=True)
    return {"_C_PREP": t_prep / n, "_C_BASE": base, "_C_CHUNKROW": chunkrow,
            "_C_PACK": t_pack / n, "_C_SORT_FIX": sort_fix, "_C_SORT_ROW": sort_row,
            "from_ms": {"rows": n, "k7_nc256": t256, f"k7_nc{min(1024, nc_all)}": t1024,
                        "prep": t_prep, "compact_valid": t_pack, "sort_rows": [n1, n2],
                        "sort": [s1, s2]}}


def _calibrated_engine(doc, fold: str, dev, batch: int = 112 * 2048):
    """A general-path engine of `doc` under IHT_FOLD=`fold`, after its
    calibration batch and two steady ones."""
    import os

    from ice_halo_sim_tpu_torch.config.loader import load_project
    from ice_halo_sim_tpu_torch.engine.simulator import Engine

    knobs = {"IHT_FOLD": fold, "IHT_PALLAS_TRACE": "0"}
    old = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        eng = Engine(load_project(doc), seed=7, batch_size=batch, device=dev)
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    eng.run(n_batches=1)
    eng.run(n_batches=2)
    return eng


def _steady_contribs(eng, batch_counter: int = 100):
    return eng._trace_batch_impl(batch_counter)[0]


def fold_prep(dev, consts: dict) -> dict:
    """_C_PREP against the engine's own sandwich fold, glue included.

    On MS_CFG, BENCH_CFG (general path) and SUNDOG_CFG, one steady batch's
    contribution rows go through the calibrated engine's sandwich fold
    (IHT_FOLD=sandwich) and through the sort fold of an IHT_FOLD=sort engine,
    each timed whole (device time). Both folds first pack the rows' keys;
    that shared part (timed alone) cancels in the dispatch's comparison and
    is taken off both. What is left of the sandwich fold, less the terms the
    K7 and compact_valid constants model (chunk rows, compacted rows), is per
    row of the levels the dispatch's row cost _C_PREP + _C_BASE: the fit is
    their sums over the three scenes, and _C_PREP the rest after _C_BASE.
    Returns the fitted constant, with each scene's times, the model's terms
    and the costs the dispatch models with the fit beside the measured ones."""
    from ice_halo_sim_tpu_torch import scenes

    per_scene = []
    for name, doc in (("ms", scenes.MS_CFG), ("bench (general path)", scenes.BENCH_CFG),
                      ("sundog", scenes.SUNDOG_CFG)):
        sw = _calibrated_engine(doc, "sandwich", dev)
        so = _calibrated_engine(doc, "sort", dev)
        c_sw, c_so = _steady_contribs(sw), _steady_contribs(so)

        def pack_keys(eng=sw, contribs=c_sw):
            for r, (pix, w, wl_idx, _mask) in enumerate(contribs):
                P = eng.proj_plans[r].height * eng.proj_plans[r].width
                _key, wz = accum.pack_spectral_keys(pix, w, wl_idx, P, eng.k_pool)
                (wz > 0.0).sum()

        t_glue = device_ms(pack_keys, 5)
        t_sw = device_ms(lambda: sw._fold_batch_sandwich(c_sw), 5)
        t_so = device_ms(lambda: so._fold_batch(c_so, so._compact_keep), 5)
        rows_t = chunk_t = pack_t = sort_rows = 0.0
        for r, levels in enumerate(sw._levels):
            n = sw._rows_per_render[r]
            for clist, keep in levels:
                if keep is not None and keep < n:
                    pack_t += n
                    n = keep
                rows_t += n
                chunk_t += n * int(clist.shape[0])
        n_renders = len(so.proj_plans)
        for r in range(n_renders):
            keep = so._compact_keep[r] if so._compact_keep else None
            n = so._rows_per_render[r]
            sort_rows += (keep if keep is not None and keep < n else n) + \
                so.proj_plans[r].height * so.proj_plans[r].width
        per_scene.append({
            "scene": name, "fold_sandwich_ms": t_sw, "fold_sort_ms": t_so,
            "shared_key_pack_ms": t_glue, "level_rows": rows_t, "chunk_rows": chunk_t,
            "compacted_rows": pack_t, "sort_rows": sort_rows, "renders": n_renders,
            "rows": float(sum(so._rows_per_render)),
            "levels": [[(int(cl.shape[0]), keep) for cl, keep in lv] for lv in sw._levels]})
        del sw, so
        torch.cuda.empty_cache()
    rest = sum(x["fold_sandwich_ms"] - x["shared_key_pack_ms"]
               - consts["_C_CHUNKROW"] * x["chunk_rows"] - consts["_C_PACK"] * x["compacted_rows"]
               for x in per_scene)
    row_cost = max(rest / sum(x["level_rows"] for x in per_scene), consts["_C_BASE"])
    prep = row_cost - consts["_C_BASE"]
    for x in per_scene:
        x["modeled_sandwich_ms"] = (row_cost * x["level_rows"] + consts["_C_CHUNKROW"]
                                    * x["chunk_rows"] + consts["_C_PACK"] * x["compacted_rows"])
        x["modeled_sort_ms"] = (consts["_C_PACK"] * x["rows"] + consts["_C_SORT_FIX"]
                                * x["renders"] + consts["_C_SORT_ROW"] * x["sort_rows"])
        x["measured_less_shared_ms"] = [x["fold_sandwich_ms"] - x["shared_key_pack_ms"],
                                        x["fold_sort_ms"] - x["shared_key_pack_ms"]]
        print(f"engine fold on {x['scene']}: sandwich {x['fold_sandwich_ms']:.4f} ms, sort "
              f"{x['fold_sort_ms']:.4f} ms, their shared key pack {x['shared_key_pack_ms']:.4f} ms;"
              f" modeled (without it) sandwich {x['modeled_sandwich_ms']:.4f}, sort "
              f"{x['modeled_sort_ms']:.4f}; levels {x['levels']}", flush=True)
    return {"_C_PREP": prep, "scenes": per_scene}


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

    key, wz = accum.pack_spectral_keys(pix, w, wl, P, K)
    acc0 = torch.zeros((P, 3), dtype=F32, device=dev)
    ks = kernel_set("cuda")
    ms = device_ms(lambda: accum.fold_spectral_keys(acc0, key, wz, K, tbl, ks))
    print(f"fold_spectral_keys (sort):  {ms:8.4f} ms", flush=True)

    timed_by()
    consts = measure_constants(dev, pix, w, wl, tbl, P, K)
    fit = fold_prep(dev, consts)
    consts["_C_PREP_probe"] = consts["_C_PREP"]
    consts["_C_PREP"] = fit["_C_PREP"]
    consts["engine_folds"] = fit["scenes"]
    print(json.dumps({"card": card, "constants_ms": consts, "timed_by": timed_by()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
