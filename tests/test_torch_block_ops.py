"""Port block pack / block scatter (plain twins of csrc/block_ops.cu)
against the JAX Pallas kernels run in the interpreter. Integer-exact
contracts: outputs must be bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ice_halo_sim_tpu.core import pallas_ops
from ice_halo_sim_tpu_torch.core import block_ops

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pallas_ops, "INTERPRET", True)


def _u32(a):
    return np.asarray(a).view(np.uint32)


def _keys(g, G, block, thresh, kinds):
    """Keys per block: 'empty' (all >= thresh), 'full' (all < thresh) or
    'mixed'."""
    out = []
    for kind in kinds[:G]:
        lo = g.integers(0, thresh, block, dtype=np.uint64)
        hi = g.integers(thresh, 1 << 32, block, dtype=np.uint64)
        if kind == "empty":
            k = hi
        elif kind == "full":
            k = lo
        else:
            k = np.where(g.random(block) < 0.3, lo, hi)
        out.append(k.astype(np.uint32))
    return np.concatenate(out)


def test_pack_payload_blocks_bit_equal(interpret):
    g = np.random.default_rng(5)
    block, thresh = 4096, 131072
    key = _keys(g, 3, block, thresh, ["mixed", "empty", "full"])
    cols = [g.normal(size=key.size).astype(np.float32) for _ in range(3)]
    jcols, jcnt = pallas_ops.pack_payload_blocks(
        jnp.asarray(key), [jnp.asarray(c) for c in cols], thresh, block)
    tcols, tcnt = block_ops.pack_payload_blocks(
        torch.as_tensor(key.view(np.int32)), [torch.as_tensor(c) for c in cols],
        thresh, block)
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    assert list(tcnt.numpy())[1:] == [0, block]
    for a, b in zip(tcols, jcols):
        np.testing.assert_array_equal(_u32(a.numpy()), _u32(b))


def test_pack_rows_carries_key_stably():
    g = np.random.default_rng(6)
    key = _keys(g, 2, 2048, 1 << 31, ["mixed", "mixed"])
    key[::7] = 0xFFFFFFFF
    w = g.random(key.size).astype(np.float32)
    pk, pw, cnt = block_ops.pack_rows(torch.as_tensor(key.view(np.int32)),
                                      torch.as_tensor(w), 2048)
    for b in range(2):
        sl = slice(b * 2048, (b + 1) * 2048)
        live = key[sl] != 0xFFFFFFFF
        n = int(live.sum())
        assert int(cnt[b]) == n
        np.testing.assert_array_equal(_u32(pk.numpy()[sl][:n]), key[sl][live])
        np.testing.assert_array_equal(pw.numpy()[sl][:n], w[sl][live])
        assert (_u32(pk.numpy()[sl][n:]) == 0xFFFFFFFF).all()
        assert (pw.numpy()[sl][n:] == 0).all()


def _scatter_inputs(g, G, blk, counts):
    counts = np.asarray(counts, np.int64)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    vals_k = g.integers(0, 1 << 32, (G, blk), dtype=np.uint64).astype(np.uint32)
    vals_w = g.normal(size=(G, blk)).astype(np.float32)
    return start, vals_k, vals_w


# G = 5 (not a multiple of the TPU kernel's 8-block step); empty blocks give
# equal starts; a full block; out_len cuts the last blocks (start >= out_len).
CASES = {
    "mixed": (5, 1024, [1000, 0, 0, 1024, 300], 2300),
    "all-empty-tail": (3, 2048, [2048, 10, 0], 2048),
    "ragged-13": (13, 1024, [512] * 13, 4096),
}


@pytest.mark.parametrize("case", list(CASES))
def test_scatter_blocks_multi_bit_equal(interpret, case):
    G, blk, counts, out_len = CASES[case]
    g = np.random.default_rng(7)
    start, vk, vw = _scatter_inputs(g, G, blk, counts)
    want = pallas_ops.scatter_blocks_multi(
        [jnp.asarray(vk), jnp.asarray(vw)], jnp.asarray(start), out_len, blk)
    got = block_ops.scatter_blocks_multi(
        [torch.as_tensor(vk.view(np.int32)), torch.as_tensor(vw)],
        torch.as_tensor(start), out_len, blk)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_u32(a.numpy()), _u32(b))


def test_scatter_blocks_multi_marker_tail_bit_equal(interpret):
    G, blk = 4, 1024
    g = np.random.default_rng(8)
    start, vk, vw = _scatter_inputs(g, G, blk, [700, 1024, 0, 900])
    out_len, tail = 8192, (4096, 4096, 7, 127)
    want = pallas_ops.scatter_blocks_multi(
        [jnp.asarray(vk), jnp.asarray(vw)], jnp.asarray(start), out_len, blk,
        marker_tail=tail)
    got = block_ops.scatter_blocks_multi(
        [torch.as_tensor(vk.view(np.int32)), torch.as_tensor(vw)],
        torch.as_tensor(start), out_len, blk, marker_tail=tail)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_u32(a.numpy()), _u32(b))
    assert _u32(got[0].numpy())[4096 + 5] == (5 << 7) | 127


@pytest.mark.parametrize("tail", [(4096, 8192, 7, 127), (-1, 10, 7, 1), (0, 10, 40, 1)])
def test_marker_tail_arguments_are_checked(tail):
    v = torch.zeros((1, 1024), dtype=torch.int32)
    with pytest.raises(ValueError):
        block_ops.scatter_blocks_multi([v], torch.zeros(1, dtype=torch.int32), 8192,
                                       1024, marker_tail=tail)


def test_scatter_blocks_hbm_sized_output_bit_equal(interpret):
    # out_len large enough that the TPU kernel takes its HBM-output variant
    # (_scatter_hbm: > 10 MB of dense output).
    G, blk = 3, 1024
    g = np.random.default_rng(9)
    start, _, vw = _scatter_inputs(g, G, blk, [1024, 512, 1024])
    start = start + np.int32(2_700_000)
    out_len = 2_703_000
    want = pallas_ops.scatter_blocks(jnp.asarray(vw), jnp.asarray(start), out_len, blk)
    got, = block_ops.scatter_blocks([torch.as_tensor(vw)], torch.as_tensor(start),
                                    out_len, blk)
    np.testing.assert_array_equal(_u32(got.numpy()), _u32(want))


# K3' as compact_by_key calls it: every column in one call, each gathered
# inside its blocks by a permutation. Starts are given outright: G = 5 and 13
# are no multiples of the TPU kernel's 8-block step; equal starts make empty
# blocks; a gap wider than the block leaves zeros; starts at or past out_len
# place nothing.
SCATTER_COLS_CASES = {
    "one-column": (1024, [0, 1000, 1000, 1000, 2024], 2300, ["f32"]),
    "seven-mixed": (1024, [0, 700, 700, 3000, 3000, 3100, 4000, 5000, 5000, 6000,
                           6500, 8000, 9000], 6500,
                    ["f32", "i32", "u32", "f32", "i32", "u32", "f32"]),
}


@pytest.mark.parametrize("case", list(SCATTER_COLS_CASES))
def test_scatter_blocks_columns_with_perm_bit_equal(interpret, case):
    """scatter_blocks_plain with several columns and an in-block permutation
    against the JAX K3' of each column gathered by it: bit-equal."""
    blk, start, out_len, kinds = SCATTER_COLS_CASES[case]
    g = np.random.default_rng(10)
    G = len(start)
    start = np.asarray(start, np.int32)
    perm = np.argsort(g.random((G, blk)), axis=1).astype(np.int32)
    cols = []
    for kind in kinds:
        if kind == "f32":
            cols.append(g.normal(size=(G, blk)).astype(np.float32))
        else:
            cols.append(g.integers(0, 1 << 32, (G, blk), dtype=np.uint64).astype(np.uint32)
                        .view(np.int32 if kind == "i32" else np.uint32))
    tcols = [torch.as_tensor(c.view(np.int32) if c.dtype == np.uint32 else c) for c in cols]
    got = block_ops.scatter_blocks(tcols, torch.as_tensor(start), out_len, blk,
                                   perm=torch.as_tensor(perm))
    assert len(got) == len(cols)
    for a, t, c in zip(got, tcols, cols):
        want = pallas_ops.scatter_blocks(jnp.asarray(np.take_along_axis(c, perm, axis=1)),
                                         jnp.asarray(start), out_len, blk)
        assert a.shape == (out_len,) and a.dtype == t.dtype
        np.testing.assert_array_equal(_u32(a.numpy()), _u32(want))


# --------------------------------------------------------------------------
# K6: pack_valid_blocks (the key carried, one or two columns, any threshold)
# --------------------------------------------------------------------------

def _one_row_keys(g, block, thresh):
    k = g.integers(thresh, 1 << 32, block, dtype=np.uint64) if thresh < (1 << 32) - 1 \
        else np.full(block, 0xFFFFFFFF, np.uint64)
    k[block // 3] = thresh - 1
    return k.astype(np.uint32)


# G = 3 and 5 are no multiples of the TPU kernel's 8-block step.
K6_CASES = {
    "f32-all-live-thresh": (["mixed", "full", "empty"], 0xFFFFFFFF, 1),
    "f32-small-thresh": (["mixed", "empty", "full", "mixed", "one"], 131072, 1),
    "f32-u32-all-live-thresh": (["one", "mixed", "full"], 0xFFFFFFFF, 2),
    "f32-u32-small-thresh": (["full", "mixed", "one", "empty", "mixed"], 1 << 20, 2),
}


@pytest.mark.parametrize("case", list(K6_CASES))
def test_pack_valid_blocks_bit_equal(interpret, case):
    """pack_valid_blocks_plain (and the wrapper on a CPU tensor) against the
    JAX kernel in the interpreter: keys, columns and counts bit-equal."""
    kinds, thresh, ncols = K6_CASES[case]
    g = np.random.default_rng(21)
    block = 4096
    parts = []
    for kind in kinds:
        if kind == "one":
            parts.append(_one_row_keys(g, block, thresh))
        elif thresh == 0xFFFFFFFF:
            # "valid" means any key but 0xFFFFFFFF
            k = g.integers(0, 0xFFFFFFFF, block, dtype=np.uint64).astype(np.uint32)
            if kind == "empty":
                k[:] = 0xFFFFFFFF
            elif kind == "mixed":
                k[g.random(block) < 0.6] = 0xFFFFFFFF
            parts.append(k)
        else:
            parts.append(_keys(g, 1, block, thresh, [kind]))
    key = np.concatenate(parts)
    cols = [g.normal(size=key.size).astype(np.float32)]
    if ncols == 2:
        cols.append(g.integers(0, 1 << 32, key.size, dtype=np.uint64).astype(np.uint32))
    jk, jcols, jcnt = pallas_ops.pack_valid_blocks(
        jnp.asarray(key), [jnp.asarray(c) for c in cols], thresh, block)
    tcols_in = [torch.as_tensor(c if c.dtype == np.float32 else c.view(np.int32)) for c in cols]
    tkey = torch.as_tensor(key.view(np.int32))
    for fn in (block_ops.pack_valid_blocks_plain, block_ops.pack_valid_blocks):
        tk, tcols, tcnt = fn(tkey, tcols_in, thresh, block)
        np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
        np.testing.assert_array_equal(_u32(tk.numpy()), np.asarray(jk))
        for a, b in zip(tcols, jcols):
            np.testing.assert_array_equal(_u32(a.numpy()), _u32(b))
    want = {"full": block, "empty": 0, "one": 1}
    for i, kind in enumerate(kinds):
        if kind in want:
            assert int(tcnt[i]) == want[kind], (i, kind)
    # The tail of every block is (0xFFFFFFFF, 0).
    for i in range(len(kinds)):
        n = int(tcnt[i])
        assert (_u32(tk.numpy())[i * block + n:(i + 1) * block] == 0xFFFFFFFF).all()
        assert (_u32(tcols[-1].numpy())[i * block + n:(i + 1) * block] == 0).all()


def test_pack_valid_blocks_checks_its_arguments():
    key = torch.zeros(4096 + 5, dtype=torch.int32)
    with pytest.raises(ValueError):
        block_ops.pack_valid_blocks(key, [torch.zeros(4101)], 7, 4096)
