"""The benchmark of the PyTorch and CUDA port (``ice_halo_sim_tpu_torch``).

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``run.py`` runs one cell once through its driver; ``workloads/``,
``configs/``, ``drivers/`` and ``metrics/`` hold one file per cell,
configuration, entry point of the port and metric, found by name;
``reference/`` is the plain reference that decides ``correct``. Nothing
here imports jax, the JAX package or ``benchmarks/``.
"""
