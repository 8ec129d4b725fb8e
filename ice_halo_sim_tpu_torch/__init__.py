"""PyTorch/CUDA port of the ice-halo renderer (``ice_halo_sim_tpu``).

The JAX package is the reference; this package renders the same scenes
through the same counter-based random streams, with every Pallas kernel on
its path replaced by a hand-written CUDA kernel for Hopper (``csrc/``).
Each kernel has a plain PyTorch twin in the same module: the twin runs on
the CPU, and on a CUDA device when an Engine is built with
``kernels="plain"``.

Configuration parsing, knobs, logging, PNG output and the latitude LUT are
imported from the JAX package's JAX-free modules; nothing here imports jax.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy entry points (importing them pulls in torch)."""
    if name == "Engine":
        from ice_halo_sim_tpu_torch.engine.simulator import Engine

        return Engine
    if name == "load_jax_checkpoint":
        from ice_halo_sim_tpu_torch.engine.checkpoint import load_jax_checkpoint

        return load_jax_checkpoint
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
