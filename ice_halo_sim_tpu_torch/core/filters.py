"""Ray-path filters with P/B/D crystal-symmetry folding (port of the engine
path of ``ice_halo_sim_tpu.core.filters``).

Host side, plain Python carried over unchanged: the D-symmetry helpers,
``reduce_raypath`` (the canonical form of a configured raypath: P
prism-rotation shift, D sigma-mirror, B basal mirror, each keeping the
lexicographically smaller form) and the static plans (``SimplePlan``,
``FilterPlan``, ``build_filter_plan``) for the filter kinds none / raypath /
entry_exit / direction / crystal and the OR-of-AND complex filter, with the
action XOR.

Device side: ``reduce_paths_t`` and ``check_exits_prefix_soa`` on slot-major
[H, B] int32 face-number paths, plain PyTorch. Every stage is integer (or a
float compare of the direction filter) and gives the JAX functions' values.
The TPU's one-hot masked sum over the path axis (``_col_at``: no per-row
gathers there) is an indexed read here. The [N, L] forms (``check_exits``,
``check_exits_slots``, ``reduce_paths``) have no caller in the engine and
are not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ice_halo_sim_tpu_torch.config.schema import (
    AxisDistribution,
    ComplexFilter,
    CrystalFilter,
    DirectionFilter,
    EntryExitFilter,
    FilterAction,
    FilterConfig,
    NoneFilter,
    RaypathFilter,
    Symmetry,
)
from ice_halo_sim_tpu_torch.core import bits

FN_PERIOD = 6  # hexagonal family


# --------------------------------------------------------------------------
# D-symmetry applicability 
# --------------------------------------------------------------------------

def is_roll_mean_multiple_of_30(roll_center_deg: float) -> bool:
    r = roll_center_deg / 30.0
    return abs(r - round(r)) < 1e-4


def compute_sigma_a(roll_mean_deg: float) -> int:
    n = (int(round(roll_mean_deg / 30.0)) % 6 + 6) % 6
    return (6 - n) % 6


def is_d_applicable(axis: AxisDistribution) -> bool:
    return axis.is_az_rotationally_symmetric() and is_roll_mean_multiple_of_30(axis.roll.center)


# --------------------------------------------------------------------------
# Host-side scalar canonicalization (for filter-config raypaths)
# --------------------------------------------------------------------------

def _p_shift_list(seq: List[int]) -> List[int]:
    out = list(seq)
    first_pri = None
    for i, x in enumerate(out):
        if x < 3:
            continue
        pyr, pri = divmod(x, 10)
        if first_pri is None:
            first_pri = pri
        pri = (pri + FN_PERIOD - first_pri) % FN_PERIOD + 3
        out[i] = pyr * 10 + pri
    return out


def _d_mirror_list(seq: List[int], sigma_a: int) -> List[int]:
    out = []
    for x in seq:
        if x < 3:
            out.append(x)
            continue
        pyr, pri = divmod(x, 10)
        new_pri0 = ((sigma_a - (pri - 3)) % FN_PERIOD + FN_PERIOD) % FN_PERIOD
        out.append(pyr * 10 + new_pri0 + 3)
    return out


def _b_mirror_list(seq: List[int]) -> Tuple[List[int], bool]:
    out = []
    changed = False
    for x in seq:
        if x <= 2:
            out.append(3 - x)
            changed = True
        elif 13 <= x <= 18:
            out.append(x + 10)
            changed = True
        elif 23 <= x <= 28:
            out.append(x - 10)
            changed = True
        else:
            out.append(x)
    return out, changed


def reduce_raypath(seq, symmetry: Symmetry, sigma_a: int = 0, d_applicable: bool = False) -> List[int]:
    """Canonical form of a face-number raypath under the symmetry set."""
    data = list(int(x) for x in seq)
    if symmetry == Symmetry.NONE:
        return data
    if symmetry & Symmetry.P:
        data = _p_shift_list(data)
    if (symmetry & Symmetry.D) and d_applicable:
        scratch = _d_mirror_list(data, sigma_a)
        if symmetry & Symmetry.P:
            scratch = _p_shift_list(scratch)
        if scratch < data:
            data = scratch
    if symmetry & Symmetry.B:
        scratch, changed = _b_mirror_list(data)
        if changed and scratch < data:
            data = scratch
    return data


# --------------------------------------------------------------------------
# Filter plans (host-built static descriptors)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class SimplePlan:
    kind: str                      # none|raypath|entry_exit|direction|crystal
    symmetry: Symmetry = Symmetry.NONE
    sigma_a: int = 0
    d_applicable: bool = False
    canonical: tuple = ()          # canonicalized face numbers
    min_len: int = 1
    max_len: Optional[int] = None
    has_entry: bool = False
    has_exit: bool = False
    dir_vec: tuple = (0.0, 0.0, 1.0)
    radii_c: float = -2.0
    crystal_match: bool = True     # resolved at build (setting crystal is static)


@dataclass(frozen=True)
class FilterPlan:
    action: FilterAction
    # OR-of-AND structure; simple filters are a single 1-clause entry.
    clauses: tuple = ()            # tuple of tuples of SimplePlan


def _build_simple(param, symmetry: Symmetry, sigma_a: int, d_applicable: bool,
                  setting_crystal_id: int) -> SimplePlan:
    if isinstance(param, NoneFilter):
        return SimplePlan(kind="none")
    if isinstance(param, RaypathFilter):
        canon = reduce_raypath(param.raypath, symmetry, sigma_a, d_applicable)
        return SimplePlan(kind="raypath", symmetry=symmetry, sigma_a=sigma_a,
                          d_applicable=d_applicable, canonical=tuple(canon))
    if isinstance(param, EntryExitFilter):
        ends = []
        if param.entry is not None:
            ends.append(param.entry)
        if param.exit is not None:
            ends.append(param.exit)
        canon = tuple(reduce_raypath(ends, symmetry, sigma_a, d_applicable)) if ends else ()
        return SimplePlan(kind="entry_exit", symmetry=symmetry, sigma_a=sigma_a,
                          d_applicable=d_applicable, canonical=canon,
                          min_len=param.min_len, max_len=param.max_len,
                          has_entry=param.entry is not None, has_exit=param.exit is not None)
    if isinstance(param, DirectionFilter):
        lat = math.radians(param.el)
        lon = math.radians(param.az)
        return SimplePlan(
            kind="direction",
            dir_vec=(math.cos(lat) * math.cos(lon), math.cos(lat) * math.sin(lon), math.sin(lat)),
            radii_c=math.cos(math.radians(param.radii)),
        )
    if isinstance(param, CrystalFilter):
        return SimplePlan(kind="crystal", crystal_match=(param.crystal_id == setting_crystal_id))
    raise ValueError(f"unexpected simple filter {param!r}")


def build_filter_plan(fcfg: FilterConfig, axis: AxisDistribution, all_filters: dict,
                      setting_crystal_id: int) -> FilterPlan:
    """The static match plan of one filter for one crystal setting."""
    d_app = is_d_applicable(axis)
    sigma_a = compute_sigma_a(axis.roll.center) if d_app else 0
    if isinstance(fcfg.param, ComplexFilter):
        clauses = []
        for clause in fcfg.param.composition:
            plans = []
            for ref in clause:
                sub = all_filters[ref]
                # Sub-filter symmetry comes from the SUB filter config; action
                # of sub-filters is ignored (only the complex's action applies).
                plans.append(
                    _build_simple(sub.param, sub.symmetry, sigma_a, d_app, setting_crystal_id)
                )
            clauses.append(tuple(plans))
        return FilterPlan(action=fcfg.action, clauses=tuple(clauses))
    simple = _build_simple(fcfg.param, fcfg.symmetry, sigma_a, d_app, setting_crystal_id)
    return FilterPlan(action=fcfg.action, clauses=((simple,),))


# --------------------------------------------------------------------------
# Slot-major match on tensors
# --------------------------------------------------------------------------

def _col_at(arr, idx):
    """arr[idx[b], b] over [L, B]."""
    return arr.gather(0, idx[None, :].long())[0]


def _first_true(mask):
    """Index of the first True along dim 0 (0 when none), as argmax gives."""
    return torch.argmax(mask.to(torch.uint8), dim=0)


def _p_shift_t(paths, valid):
    is_pri = (paths >= 3) & valid
    has_pri = is_pri.any(dim=0)
    first_val = _col_at(paths, _first_true(is_pri))
    first_pri = torch.where(has_pri, first_val % 10, 0)
    pyr = paths // 10
    pri = paths % 10
    new_pri = (pri + FN_PERIOD - first_pri[None, :]) % FN_PERIOD + 3
    return torch.where(is_pri, pyr * 10 + new_pri, paths)


def _d_mirror_t(paths, valid, sigma_a):
    is_pri = (paths >= 3) & valid
    pyr = paths // 10
    pri0 = paths % 10 - 3
    new_pri0 = (sigma_a - pri0) % FN_PERIOD
    return torch.where(is_pri, pyr * 10 + new_pri0 + 3, paths)


def _b_mirror_t(paths, valid):
    basal = (paths <= 2) & valid
    upper = (paths >= 13) & (paths <= 18) & valid
    lower = (paths >= 23) & (paths <= 28) & valid
    out = torch.where(basal, 3 - paths, paths)
    out = torch.where(upper, paths + 10, out)
    out = torch.where(lower, paths - 10, out)
    changed = (basal | upper | lower).any(dim=0)
    return out, changed


def _lex_less_t(a, b, valid):
    diff = (a != b) & valid
    any_diff = diff.any(dim=0)
    idx = _first_true(diff)
    return any_diff & (_col_at(a, idx) < _col_at(b, idx))


def reduce_paths_t(paths, valid, symmetry: Symmetry, sigma_a: int,
                   d_applicable: bool):
    """Canonical form of slot-major [L, B] int32 paths (``reduce_raypath``
    per column over its valid rows)."""
    data = torch.where(valid, paths, 0)
    if symmetry == Symmetry.NONE:
        return data
    if symmetry & Symmetry.P:
        data = _p_shift_t(data, valid)
    if (symmetry & Symmetry.D) and d_applicable:
        scratch = _d_mirror_t(data, valid, sigma_a)
        if symmetry & Symmetry.P:
            scratch = _p_shift_t(scratch, valid)
        take = _lex_less_t(scratch, data, valid)
        data = torch.where(take[None, :], scratch, data)
    if symmetry & Symmetry.B:
        scratch, changed = _b_mirror_t(data, valid)
        take = changed & _lex_less_t(scratch, data, valid)
        data = torch.where(take[None, :], scratch, data)
    return data


def check_exits_prefix_soa(plan: Optional[FilterPlan], path, live, dirs):
    """Filter verdicts for every exit slot, slot-major.

    path: [H, B] int32 face numbers (slot h's raypath = path[:h+1, b]);
    live: [H, B] bool (slot emitted); dirs: (dx, dy, dz) each [H, B] world
    exit directions. Returns [H, B] bool verdicts (match XOR filter_out).
    A raypath predicate of canonical length C can only match at slot
    h == C - 1, so every other slot skips it on the host."""
    H, B = path.shape
    dev = path.device
    if plan is None:
        return torch.ones((H, B), dtype=torch.bool, device=dev)
    dx, dy, dz = dirs

    def const(v):
        return torch.full((B,), v, dtype=torch.bool, device=dev)

    rows = []
    for h in range(H):
        p = path[: h + 1]
        lv = live[h]
        valid = lv[None, :].expand(h + 1, B)
        cache = {}

        def reduced_for(s, p=p, valid=valid, cache=cache):
            k = (s.symmetry, s.sigma_a, s.d_applicable)
            if k not in cache:
                cache[k] = reduce_paths_t(p, valid, *k)
            return cache[k]

        def canon_col(s):
            return bits.const(np.asarray(s.canonical, np.int32), dev)[:, None]

        matched = None
        for clause in plan.clauses:
            and_ok = None
            for s in clause:
                if s.kind == "none":
                    continue
                elif s.kind == "crystal":
                    if s.crystal_match:
                        continue
                    and_ok = const(False)
                    break
                elif s.kind == "direction":
                    dvec = s.dir_vec
                    m = (dx[h] * dvec[0] + dy[h] * dvec[1] + dz[h] * dvec[2]) > s.radii_c
                elif s.kind == "raypath":
                    if len(s.canonical) != h + 1:
                        and_ok = const(False)
                        break
                    m = lv & (reduced_for(s) == canon_col(s)).all(dim=0)
                elif s.kind == "entry_exit":
                    if (h + 1) < s.min_len or (
                        s.max_len is not None and (h + 1) > s.max_len
                    ):
                        and_ok = const(False)
                        break
                    if not (s.has_entry or s.has_exit):
                        m = lv
                    else:
                        ends = []
                        if s.has_entry:
                            ends.append(p[0])
                        if s.has_exit:
                            ends.append(p[h])
                        ee = torch.stack(ends, dim=0)        # [1|2, B]
                        if len(s.canonical) != ee.shape[0]:
                            and_ok = const(False)
                            break
                        red = reduce_paths_t(
                            ee, torch.ones_like(ee, dtype=torch.bool), s.symmetry,
                            s.sigma_a, s.d_applicable)
                        m = lv & (red == canon_col(s)).all(dim=0)
                else:
                    raise ValueError(s.kind)
                and_ok = m if and_ok is None else (and_ok & m)
            if and_ok is None:       # every predicate of the clause is trivially true
                and_ok = const(True)
            matched = and_ok if matched is None else (matched | and_ok)
        if matched is None:
            matched = const(False)
        if plan.action == FilterAction.FILTER_OUT:
            matched = ~matched
        rows.append(matched)
    return torch.stack(rows, dim=0)
