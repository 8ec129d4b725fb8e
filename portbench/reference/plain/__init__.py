"""Frozen copies of the port's plain modules, so that the reference does
not move when the port does.

Each file is the part of the port's file of the same path under
``ice_halo_sim_tpu_torch/`` (as of commit 0772466) that the trace kernel's
plain statement needs, with its imports pointed here: the configuration's
schema and loader, the RNG, the sampling of the sun, wavelengths and
orientations, the crystal geometry, the optics, the projection, and
``core/trace_emit.trace_rows_plain`` (whose landed and dropped weights are
float64 sums here). Nothing here builds or launches a kernel, folds, or
runs a host loop: the reference folds by ``index_add_`` (``oracle.py``).
"""
