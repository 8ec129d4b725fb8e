"""Probe: the marker-extraction block scatter (port of
``scripts/probe_pallas_scatter.py``, the probe form P2 of kernel K3; its
``pallas_call`` is at ``:121``).

    python -m ice_halo_sim_tpu_torch.probe_scatter

The function: ``out[start[g] : start[g] + block] = vals[g]`` for g = 0, 1,
..., later blocks overwriting earlier ones, cut to P entries. The TPU probe
shifts every block into place with static lane and sublane rolls and blends
it into an aligned window of a VMEM-resident image; none of that is carried
over. With nondecreasing starts the block that wrote entry p last is the last
one with ``start[g] <= p``, so block g owns the window [start[g], start[g +
1]). The port's block scatter kernel (csrc/block_ops.cu
``scatter_tiles_kernel``, one payload) gives each thread block a tile of
output rows, finds the blocks around the tile once, gives every row of the
tile its owner by a max-scan of the windows that start inside it, and writes
each entry once, at any block length; it is bound by
memory bandwidth (each entry written once, each covered value read once).
``extract_blocks`` is that kernel behind its own wrapper and launch counter.
The plain version writes the blocks in order.

On one CUDA device the probe holds the kernel against the plain version at
the TPU probe's shapes (G = 192 blocks of 16384, P = 131072) and prints one
JSON line with both device times.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from ice_halo_sim_tpu_torch.core import block_ops
from ice_halo_sim_tpu_torch.core.bits import F32, I32
from ice_halo_sim_tpu_torch.kernels import build


def extract_blocks_plain(vals, start, n_out: int, block: int):
    """Plain version: write block g at start[g], in order, and cut to n_out.
    vals [G, block], start [G] int32."""
    G, blk = vals.shape
    if blk != block:
        raise ValueError(f"vals has blocks of {blk}, not {block}")
    out = torch.zeros(n_out + block, dtype=vals.dtype, device=vals.device)
    for g, s in enumerate(start.tolist()):
        if 0 <= s < n_out:
            out[s:s + block] = vals[g]
    return out[:n_out].clone()


def extract_blocks(vals, start, n_out: int, block: int):
    """P2 wrapper: the plain version on CPU tensors, the block scatter kernel
    on CUDA tensors. start must be nondecreasing."""
    if vals.device.type == "cpu":
        return extract_blocks_plain(vals, start, n_out, block)
    if vals.dim() != 2 or vals.shape[1] != block or start.shape != (vals.shape[0],):
        raise ValueError(f"extract_blocks takes vals [G, {block}] and start [G]")
    out = block_ops._scatter_blocks_cuda([vals], start, n_out, block)[0]
    build.LAUNCHES["extract_blocks"] += 1
    return out


def probe_inputs(device, seed: int = 0, n_out: int = 512 * 256, block: int = 16384,
                 n_rows: int = 3 * 1024 * 1024):
    """The TPU probe's shapes: G = n_rows / block blocks, each with up to
    1199 leading entries that count, placed back to back."""
    g = torch.Generator().manual_seed(seed)
    G = n_rows // block
    vals = torch.rand((G, block), generator=g, dtype=F32)
    cnt = torch.randint(0, 1200, (G,), generator=g)
    cnt = cnt * (n_out // max(1, int(cnt.sum())))
    start = (torch.cumsum(cnt, 0) - cnt).to(I32)
    return vals.to(device), start.to(device), n_out, block


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_scatter: no CUDA device", file=sys.stderr)
        return 1
    from ice_halo_sim_tpu_torch.probe_sandwich import device_ms, timed_by

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    vals, start, n_out, block = probe_inputs(dev)
    got = extract_blocks(vals, start, n_out, block)
    want = extract_blocks_plain(vals, start, n_out, block)
    ok = bool(torch.equal(got, want))
    timed_by()
    kernel_ms = device_ms(lambda: extract_blocks(vals, start, n_out, block))
    plain_ms = device_ms(lambda: extract_blocks_plain(vals, start, n_out, block), 3)
    print(json.dumps({
        "card": card, "match": ok, "G": vals.shape[0], "block": block, "P": n_out,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "timed_by": timed_by(),
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
