#!/usr/bin/env python
"""Steady milliseconds per batch of BENCH_CFG through the port's Engine, for
the tree in the current directory, on one CUDA device. To compare two
commits, unpack the parent with `git archive` into a directory that
.gitignore lists and run, within one call on one card, in turns:

    (cd PARENT && python3 /path/to/torch_rate_probe.py parent)
    python3 scripts/torch_rate_probe.py change
    python3 scripts/torch_rate_probe.py change
    (cd PARENT && python3 /path/to/torch_rate_probe.py parent)

Prints the label and five windows of 20 calibrated batches each. The rate
is host-bound, so it moves with the host's load; read the spread.
"""

import sys
import time

sys.path.insert(0, ".")

import torch

try:
    from ice_halo_sim_tpu_torch.config.loader import load_project
    from ice_halo_sim_tpu_torch.scenes import BENCH_CFG
except ImportError:  # a tree from before the port had its own config and scenes
    from bench import BENCH_CFG
    from ice_halo_sim_tpu.config.loader import load_project
from ice_halo_sim_tpu_torch.engine.simulator import Engine


def main() -> int:
    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    eng = Engine(load_project(BENCH_CFG), seed=7, batch_size=112 * 2048, device="cuda")
    eng.run(n_batches=1)
    eng.run(n_batches=3)
    torch.cuda.synchronize()
    out = []
    for _ in range(5):
        t0 = time.perf_counter()
        eng.run(n_batches=20)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / 20 * 1e3)
    print(label, "ms/batch", " ".join(f"{x:.3f}" for x in out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
