"""Counter-based per-ray random streams (port of ``ice_halo_sim_tpu.core.rng``).

The same stateless hash ``pcg_hash(seed ^ pcg_hash(idx * 1000003 + slot))``
keyed by explicit (seed, index, slot); streams are bit-identical to the JAX
package. No torch RNG state is used anywhere.

u32 values travel as int64 tensors masked to 32 bits (see core/bits.py).
``seed`` and ``idx`` arguments may be python ints or int64 tensors.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.plain.config.schema import DistType
from portbench.reference.plain.core.bits import F32, I64, MASK32

NONCE_WL = 0x9E3779B9
NONCE_GEOM_SHAPE = 0x85EBCA6B
NONCE_ORIENT = 0xC2B2AE35
NONCE_SUN = 0x27D4EB2F
NONCE_ENTRY = 0x165667B1
NONCE_GATE = 0xD3A2646C
NONCE_SHUFFLE = 0xFD7046C5
NONCE_EMIT = 0x94D049BB

TWO_PI = 2.0 * math.pi
SLOTS_PER_DIST = 2


def _t(x, like=None):
    if isinstance(x, torch.Tensor):
        return x.to(I64)
    dev = like.device if isinstance(like, torch.Tensor) else None
    # A fill, not a copy from host memory: capturable in a CUDA graph.
    return torch.full((), int(x) & MASK32, dtype=I64, device=dev)


def pcg_hash(x):
    """pcg_shared.h:192-196 on int64-held u32 values."""
    x = _t(x) & MASK32
    x = (x * 747796405 + 2891336453) & MASK32
    x = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & MASK32
    return (x >> 22) ^ x


def u01(h):
    """Uniform in [0, 1) from a 32-bit hash. Same value as the JAX version
    (there the convert goes through int32, a Mosaic workaround: the shifted
    value is < 2^24, so both converts are exact)."""
    return (h >> 8).to(F32) * (1.0 / 16777216.0)


def hi_epoch_seed(seed, base_hi):
    """Mix the high half of a 64-bit ray base into the seed (identity when
    base_hi == 0)."""
    seed = _t(seed, base_hi)
    base_hi = _t(base_hi, seed)
    return torch.where(base_hi == 0, seed, seed ^ pcg_hash(base_hi))


def epoch_seed(seed, base_lo, base_hi, idx):
    """Per-ray seed for the 64-bit ray index (base_hi, base_lo) + offset,
    where idx is the wrapped low word: a wrap carries into the hi epoch."""
    idx = _t(idx)
    carry = (idx < _t(base_lo, idx)).to(I64)
    hi = (_t(base_hi, idx) + carry) & MASK32
    seed = _t(seed, idx)
    return torch.where(hi == 0, seed, seed ^ pcg_hash(hi))


def mul_u32_split(c, s: int):
    """(c * s) as (lo, hi) u32 words, by the same 16-bit split as the JAX
    version (c: int64-held u32 tensor, s: static int < 2^32)."""
    s = int(s) & MASK32
    c = _t(c) & MASK32
    s_lo, s_hi = s & 0xFFFF, s >> 16
    c_lo, c_hi = c & 0xFFFF, c >> 16
    p_ll = c_lo * s_lo
    p_lh = c_lo * s_hi
    p_hl = c_hi * s_lo
    p_hh = c_hi * s_hi
    mid = (p_lh + p_hl) & MASK32
    mid_carry = (mid < p_lh).to(I64)
    lo = (p_ll + (mid << 16)) & MASK32
    lo_carry = (lo < p_ll).to(I64)
    hi = (p_hh + (mid >> 16) + (mid_carry << 16) + lo_carry) & MASK32
    return lo, hi


def uniform(seed, idx, slot):
    """One u01 draw for stream (seed, idx) at draw-slot `slot`."""
    idx = _t(idx)
    inner = pcg_hash((idx * 1000003 + int(slot)) & MASK32)
    return u01(pcg_hash(_t(seed, idx) ^ inner))


def gaussian(seed, idx, slot):
    """Box-Muller standard normal; consumes slots [slot, slot+1]."""
    u1 = torch.clamp_min(uniform(seed, idx, slot), 1e-7)
    u2 = uniform(seed, idx, slot + 1)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
        torch.tensor(TWO_PI, dtype=F32) * u2
    )


def sample_dist(seed, idx, slot, dtype: int, center, spread):
    """Draw from one Distribution of STATIC type `dtype` (every engine call
    site has one). center/spread: float32-representable scalars."""
    dtype = int(dtype)
    idx = _t(idx)
    center = float(center)
    spread = float(spread)
    if dtype == DistType.NO_RANDOM:
        return torch.full(idx.shape, center, dtype=F32, device=idx.device)
    if dtype == DistType.UNIFORM:
        return (uniform(seed, idx, slot) - 0.5) * spread + center
    if dtype in (DistType.GAUSS, DistType.GAUSS_LEGACY):
        return gaussian(seed, idx, slot) * spread + center
    if dtype == DistType.ZIGZAG:
        u = uniform(seed, idx, slot)
        two_pi = torch.tensor(TWO_PI, dtype=F32)
        return torch.abs(spread * torch.sin(u * two_pi) + center)
    if dtype == DistType.LAPLACIAN:
        u = uniform(seed, idx, slot)
        sgn = torch.where(u < 0.5, -1.0, 1.0).to(F32)
        arg = torch.clamp_min(1.0 - 2.0 * torch.abs(u - 0.5), 1e-30)
        return center - spread * sgn * torch.log(arg)
    raise ValueError(f"unknown DistType {dtype}")


def feistel_bijection(i, n: int, seed):
    """Seeded bijection on [0, n): a 4-round balanced Feistel network with
    cycle-walking (pcg_shared.h:550-605). i: int64-held u32 tensor; n a
    static python int. The JAX function walks in a while_loop; here the
    walk is a host loop that ends when every element is in range (at most
    64 passes, as there)."""
    n = int(n)
    i = _t(i)
    if n <= 1:
        return i
    if n == 2:
        return i ^ 1
    bits = 0
    while bits < 30 and (1 << bits) < n:
        bits += 1
    if bits & 1:
        bits += 1
    half = bits >> 1
    hm = (1 << half) - 1
    seed = _t(seed, i) & MASK32

    def one_pass(cur):
        left = (cur >> half) & hm
        right = cur & hm
        for rc in (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F):
            f = pcg_hash(seed ^ right ^ rc) & hm
            left, right = right, left ^ f
        return (left << half) | right

    cur = one_pass(i & MASK32)
    if (1 << bits) == n:
        return cur
    for _ in range(64):
        out = cur >= n
        if not bool(out.any()):
            break
        cur = torch.where(out, one_pass(cur), cur)
    return torch.where(cur < n, cur, cur % n)
