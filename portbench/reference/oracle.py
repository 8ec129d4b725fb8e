"""The reference's fold and stats, and the numbers that decide ``correct``.

The port folds each batch into every render's float32 [P, 3] accumulator:
per pixel the float64 sum of the rows' float32 products weight x CIE
basis, rounded once to float32, then added in float32
(``core/seg_scan.py``, ``core/accum.py``). The reference folds the rows of
``scene.Scene.batch_rows`` the same way with ``index_add_`` in float64 (no
sort, no scan, no compaction), batch after batch, so that its image after
a run of batches matches the port's to the last bits but for a rare
rounding of a float64 sum taken in another order.

The port's stats (``Engine.drain_stats``): the landed weight, each batch's
float32 sum added to a float32 running total per render, and the dropped
weight (the emit floor's roulette: weight removed less weight raised), each
batch's float32 sum added to a float64 total. The reference takes both as
float64 sums of the same terms.

``bf16=True`` is the control: the reference computed one precision below
what the configuration states, in the program's place. Every row's weight
is rounded to bfloat16 before the fold (a bfloat16 fold, such as the
port's sandwich fold); the landed weight's batch sums and running total are
bfloat16, and the dropped weight's batch sums bfloat16 with a float32
total.
"""

from __future__ import annotations

import math

import torch

F32, F64, I64, BF16 = torch.float32, torch.float64, torch.int64, torch.bfloat16


def batch_sums(scene, rows, bf16: bool = False) -> list:
    """One batch's per-pixel totals, float32 [P, 3] per render."""
    out = []
    tbl = scene.basis_tbl.to(F32)
    for pp, (pix, w, wl) in zip(scene.proj_plans, rows):
        if bf16:
            w = w.to(BF16).to(F32)
        vals = (tbl[wl] * w[:, None]).to(F64)
        s = torch.zeros((pp.height * pp.width, 3), dtype=F64, device=w.device)
        s.index_add_(0, pix, vals)
        out.append(s.to(F32))
    return out


def _add(total: float, term: float, dtype) -> float:
    """total + term in `dtype` (both rounded to it first)."""
    t = torch.tensor(total, dtype=F64).to(dtype) + torch.tensor(term, dtype=F64).to(dtype)
    return float(t)


def replay(scene, start: list, batches, bf16: bool = False, landed0: float = 0.0,
           dropped0: float = 0.0) -> dict:
    """The images after `batches` (batch indices, in order) are folded into
    `start` (float32 [P, 3] per render, on the scene's device), with the
    traced segments, the live contribution rows per render, and the landed
    and dropped weights' totals from `landed0` and `dropped0` (the
    program's before the first of `batches`), each summed over the
    batches."""
    images = [t.to(device=scene.device, dtype=F32).clone() for t in start]
    segs = 0
    live = [0] * len(images)
    landed, dropped = float(landed0), float(dropped0)
    for c in batches:
        rows, landed_b, dropped_b, s = scene.batch_rows(c)
        segs += s
        for r, img in enumerate(batch_sums(scene, rows, bf16)):
            images[r] = images[r] + img
            live[r] += int(rows[r][0].shape[0])
        if bf16:
            for x in landed_b:
                landed = _add(landed, x, BF16)
            dropped = _add(dropped, float(torch.tensor(dropped_b).to(BF16)), F32)
        else:
            landed += sum(landed_b)
            dropped += dropped_b
    return {"images": images, "segs": segs, "live_rows": live, "landed": landed,
            "dropped": dropped, "batches": len(batches)}


def _ulps(a, b):
    """|a - b| in float32 ulps of the larger magnitude, element by element."""
    big = torch.maximum(a.abs(), b.abs()).to(F32)
    ulp = (torch.nextafter(big, torch.full_like(big, float("inf"))) - big).to(F64)
    return (a.to(F64) - b.to(F64)).abs() / ulp


def image_gap(port: list, ref: list, base: list) -> dict:
    """How far the port's images lie from the reference's, both folded from
    the same `base` images: the largest gap in float32 ulps, and the L1 of
    the gaps with the L1 of what the reference added beside it."""
    ulp_max, gap, added = 0.0, 0.0, 0.0
    for p, r, b in zip(port, ref, base):
        p, r, b = (t.to("cpu", F32).reshape(-1, 3) for t in (p, r, b))
        if p.shape != r.shape:
            return {"ulp_max": float("inf"), "gap_l1": float("inf"), "added_l1": 1.0}
        ulp_max = max(ulp_max, float(_ulps(p, r).max()) if p.numel() else 0.0)
        gap += float((p.to(F64) - r.to(F64)).abs().sum())
        added += float((r.to(F64) - b.to(F64)).abs().sum())
    return {"ulp_max": ulp_max, "gap_l1": gap, "added_l1": added}


def stats_gap(port_landed: float, port_dropped: float, ref: dict, landed0: float,
              dropped0: float) -> dict:
    """How far the port's landed and dropped totals lie from the
    reference's, both from the same totals before the span, each gap over
    the landed weight that the reference added in the span (the dropped
    weight's net can lie near zero, and its scale is the weight in play)."""
    added = ref["landed"] - landed0
    if not added > 0:
        return {"landed": float("inf"), "dropped": float("inf")}
    return {"landed": abs(port_landed - ref["landed"]) / added,
            "dropped": abs(port_dropped - ref["dropped"]) / added}


NUMBERS = ("image_gap_l1", "image_gap_ulp", "landed_gap", "dropped_gap", "segments_off")


def compare(spans, limits: dict, control: str = "") -> tuple:
    """Hold the program's record at the end of each span against the
    reference's replay of the span: (checks {name: (value, limit)}, [the
    span broke a limit], reference record {batches, live_rows}, every
    number worked out {name: value}).

    `spans`: [(scene, batches, base, port)], where base and port are
    records {images (float32 [P, 3] per render), segments, landed,
    dropped}: the program's before the span's batches (zero images and
    totals for a span from the start) and after them. The numbers compared
    are those that `limits` names, and the traced segments, exactly; each
    is the worst over the spans but ``image_gap_l1``, the L1 of the gaps
    over the L1 of what the reference added, both summed over the spans.
    `control`: "" (the program's records), "reference_bf16" (the reference
    one precision lower in the program's place), "program" (the program
    under the control's knobs: its own records)."""
    worst = {k: 0.0 for k in NUMBERS}
    worst["segments_off"] = 0
    limits = dict(limits, segments_off=0)
    bad, gap_l1, added_l1 = [], 0.0, 0.0
    ref = {"batches": 0, "live_rows": None}
    for scene, batches, base, port in spans:
        l0, d0 = base["landed"], base["dropped"]
        rep = replay(scene, base["images"], batches, landed0=l0, dropped0=d0)
        if control == "reference_bf16":
            low = replay(scene, base["images"], batches, bf16=True, landed0=l0, dropped0=d0)
            port = dict(port, images=low["images"], landed=low["landed"],
                        dropped=low["dropped"], segments=base["segments"] + low["segs"])
        g = image_gap(port["images"], rep["images"], base["images"])
        st = stats_gap(port["landed"], port["dropped"], rep, l0, d0)
        span = {"image_gap_l1": g["gap_l1"] / g["added_l1"] if g["added_l1"] > 0 else math.inf,
                "image_gap_ulp": g["ulp_max"], "landed_gap": st["landed"],
                "dropped_gap": st["dropped"],
                "segments_off": abs(port["segments"] - base["segments"] - rep["segs"])}
        bad.append(any(span[k] > limits[k] for k in limits))
        worst = {k: max(worst[k], span[k]) for k in worst}
        gap_l1 += g["gap_l1"]
        added_l1 += g["added_l1"]
        ref["batches"] += rep["batches"]
        ref["live_rows"] = (rep["live_rows"] if ref["live_rows"] is None else
                            [a + b for a, b in zip(ref["live_rows"], rep["live_rows"])])
    worst["image_gap_l1"] = gap_l1 / added_l1 if added_l1 > 0 else math.inf
    return {k: (worst[k], limits[k]) for k in limits}, bad, ref, worst
