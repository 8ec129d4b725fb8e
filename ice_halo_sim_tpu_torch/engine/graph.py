"""One steady batch of an Engine, captured as a CUDA graph and replayed.

The JAX engine runs IHT_STEPS_PER_DISPATCH batches in one device program
(a ``fori_loop`` under ``jit``), so the host pays one dispatch per k
batches. The port's batch is some 60 (BENCH_CFG) to 5000 (MS_CFG) kernel
launches through PyTorch's dispatcher; launched one by one from Python they
cost more host time than the card needs to run them. A CUDA graph records
the launches of one batch once and replays them with one call.

A batch is capturable because nothing in it is a host value that changes
between batches: the batch counter, the ray base and the pool sampler's
shape index live on the device and are advanced there; the accumulators
and the running sums are updated in place at fixed addresses; the choice
between the compacted and the full fold is not made inside the batch (the
captured batch always compacts and records an overflow on the device; the
engine reads that once per dispatch and replays the dispatch up to the
overflowing batch, which it then runs eagerly).

No fallback: a capture or a replay that fails raises.

Launch counts (``kernels.build.LAUNCHES``): a capture records launches, it
does not run them, so the counts its wrappers added are taken back and
added again on every replay, which launches each recorded kernel once.
"""

from __future__ import annotations

import torch

from ice_halo_sim_tpu_torch.kernels import build


class BatchGraph:
    """`step` (one batch, all its effects on tensors that outlive it)
    captured on `device`. Construction runs one real batch first, eagerly on
    a side stream (the warm-up that PyTorch asks of a capture: first-use
    allocations and module loads happen there), then captures one call,
    which runs nothing. ``replay`` runs one more batch. `key` records what
    the capture assumed (plan, addresses); the owner compares it to decide
    when to capture again."""

    def __init__(self, step, key, device):
        self.key = key
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        # Everything under `device`: its side stream, its capture stream (not
        # torch's default capture stream, made once on whichever device was
        # current first) and the current device the kernels launch on.
        with torch.cuda.device(device):
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                step()
            torch.cuda.current_stream(device).wait_stream(side)
            before = dict(build.LAUNCHES)
            # thread_local: the capture may run on a server's pump thread
            # while another thread uses the card (in the default "global"
            # mode a CUDA call from any thread during the capture would
            # abort it).
            with torch.cuda.graph(self.graph, stream=torch.cuda.Stream(device),
                                  capture_error_mode="thread_local"):
                step()
        self.launches = {k: v - before[k] for k, v in build.LAUNCHES.items() if v != before[k]}
        for k, v in self.launches.items():
            build.LAUNCHES[k] -= v

    def replay(self) -> None:
        with torch.cuda.device(self.device):
            self.graph.replay()
        for k, v in self.launches.items():
            build.LAUNCHES[k] += v
