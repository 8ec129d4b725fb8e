"""PyTorch/CUDA port of the ice-halo renderer (``ice_halo_sim_tpu``).

The JAX package is the reference; this package renders the same scenes
through the same counter-based random streams, with every Pallas kernel on
its path replaced by a hand-written CUDA kernel for Hopper (``csrc/``).
Each kernel has a plain PyTorch twin in the same module: the twin runs on
the CPU, and on a CUDA device when an Engine is built with
``kernels="plain"``.

Configuration parsing (``config/``), knobs, logging and PNG output
(``utils/``), the latitude LUT (``core/latlut.py``) and the CIE tables
(``data/``) are the port's own copies of the JAX package's JAX-free modules,
under the same names; nothing here imports jax or the JAX package.
"""

__version__ = "0.1.0"

from ice_halo_sim_tpu_torch.config.builder import SceneBuilder  # noqa: F401
from ice_halo_sim_tpu_torch.config.loader import load_project, load_project_file  # noqa: F401
from ice_halo_sim_tpu_torch.config.serialize import project_to_dict, project_to_json  # noqa: F401


def __getattr__(name):
    """Lazy entry points (importing them pulls in torch)."""
    if name == "Engine":
        from ice_halo_sim_tpu_torch.engine.simulator import Engine

        return Engine
    if name == "Server":
        from ice_halo_sim_tpu_torch.engine.server import Server

        return Server
    if name in ("save_checkpoint", "load_checkpoint", "load_jax_checkpoint"):
        from ice_halo_sim_tpu_torch.engine import checkpoint

        return getattr(checkpoint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
