"""Several processes, each with its local devices, as one data-parallel run
(port of ``ice_halo_sim_tpu.parallel.distributed``) over
``torch.distributed``.

Every process runs the same program. ``init_multi_host`` joins it to one
process group (a TCP rendezvous at the coordinator's address), and
``MultiHostEngine`` is a ``ShardedEngine`` over this process's local
devices whose shards take global indices: the local counts of the lower
ranks, then the local index (JAX's global device order). The batches need no
communication. At start there are two small all-gathers (the local shard
counts, and the calibration digests, so that a diverged plan fails on every
rank at once instead of hanging one); at drain the local sum is followed by
one all-reduce (SUM), so every process holds the same image.

Backends: "nccl" for CUDA devices, "gloo" for the CPU, unless the caller
names one. NCCL refuses two ranks on one device; such a run names "gloo"
(its collectives then go through host memory). Nothing switches the backend
by itself.

Tested without several hosts by local processes on a localhost port
(tests/test_torch_multihost.py), as the JAX package's tests do.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ice_halo_sim_tpu_torch.config.schema import ProjectConfig
from ice_halo_sim_tpu_torch.parallel.sharding import ShardedEngine, make_mesh
from ice_halo_sim_tpu_torch.utils.log import get_logger

# This process's devices as init_multi_host's local_device_ids named them.
_local_device_ids: Optional[list] = None


def init_multi_host(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_ids: Optional[list] = None,
    backend: Optional[str] = None,
) -> None:
    """Join this process to the run's process group. Call once, in every
    process, before MultiHostEngine. coordinator_address: "host:port" of
    the rendezvous (rank 0 listens there). local_device_ids: this process's
    CUDA devices (default: every visible one)."""
    global _local_device_ids
    if backend is None:
        backend = "nccl" if local_device_ids or torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id))
    _local_device_ids = None if local_device_ids is None else [int(i) for i in local_device_ids]
    get_logger("parallel").info(
        "multi-host init: process %d/%d, backend %s, local devices %s",
        dist.get_rank(), dist.get_world_size(), backend,
        "all visible" if _local_device_ids is None else _local_device_ids,
    )


def _local_devices() -> list:
    """This process's devices: init_multi_host's local_device_ids, else
    every visible CUDA device."""
    if _local_device_ids is not None:
        return [torch.device("cuda", i) for i in _local_device_ids]
    return make_mesh()


class MultiHostEngine(ShardedEngine):
    """ShardedEngine over the shards of every process. Construct after
    init_multi_host, in every process, with the same (cfg, seed,
    per_device_batch). mesh: this process's devices (default: those
    init_multi_host's local_device_ids named, else every visible CUDA
    device; on the CPU, for example ``["cpu"] * 2``)."""

    def __init__(self, cfg: ProjectConfig, seed: int = 1,
                 per_device_batch: int = 1 << 17, mesh: Optional[list] = None, **kw):
        if not dist.is_initialized():
            raise RuntimeError("MultiHostEngine: call init_multi_host first")
        super().__init__(cfg, _local_devices() if mesh is None else mesh, seed=seed,
                         per_device_batch=per_device_batch, **kw)

    @property
    def process_index(self) -> int:
        return dist.get_rank()

    @property
    def process_count(self) -> int:
        return dist.get_world_size()

    def _comm(self):
        """(device the collectives' tensors live on, its context): the first
        local card for NCCL, the host for gloo."""
        if dist.get_backend() == "nccl":
            return self.mesh[0], torch.cuda.device(self.mesh[0])
        return torch.device("cpu"), contextlib.nullcontext()

    def _all_gather(self, t: torch.Tensor) -> torch.Tensor:
        dev, ctx = self._comm()
        with ctx:
            t = t.to(dev)
            out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
            dist.all_gather(out, t)
            return torch.stack(out).cpu()

    def _shard_layout(self, n_local: int) -> tuple:
        counts = self._all_gather(torch.tensor([n_local], dtype=torch.int64))[:, 0]
        return int(counts[:dist.get_rank()].sum()), int(counts.sum())

    def _gather_digests(self, digests: np.ndarray) -> np.ndarray:
        # Each process gives its first digest and its first that differs
        # from it (or the first again), so every process sees a local
        # divergence too and all of them raise together.
        differs = [d for d in digests if (d != digests[0]).any()]
        mine = np.stack([digests[0], differs[0] if differs else digests[0]])
        return self._all_gather(torch.from_numpy(mine)).reshape(-1, mine.shape[1]).numpy()

    def _reduce(self, t: torch.Tensor) -> torch.Tensor:
        dev, ctx = self._comm()
        with ctx:
            c = t.to(dev, copy=True)
            dist.all_reduce(c, op=dist.ReduceOp.SUM)
            return c.to(t.device)
