"""rays_per_s (host clock): every root ray of every batch completed in the
measured window over the window's whole wall time, which ends with the
host copy of every render's image. Not a median of windows: a stall
counts in full."""


def read(ctx):
    w = ctx.window
    return w["rays"] / w["wall_s"] if w["wall_s"] > 0 else None
