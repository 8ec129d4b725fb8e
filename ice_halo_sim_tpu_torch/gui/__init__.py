"""Minimal live-view GUI front-end (stdlib HTTP server + browser page).

The port's copy of the JAX package's web viewer, over the port's
ice_halo_sim_tpu_torch.engine.server.Server: live image polling,
display-time exposure control (EV-auto), project save and load, a crystal
mesh preview, and config re-commit with the appearance-vs-layout split
deciding whether accumulation restarts.

    python -m ice_halo_sim_tpu_torch.gui.app scene.json --device cuda
"""

from ice_halo_sim_tpu_torch.gui.app import serve  # noqa: F401
