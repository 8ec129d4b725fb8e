"""kernels_per_batch (device trace): the device operations (kernels, copies
and memsets, those a CUDA graph replays included) in the profiled window of
graph replays, over its batches: a count that a fusion shrinks."""


def read(ctx):
    p = ctx.profile
    if p is None or not p.device:
        return None
    return len(p.device) / ctx.profile_batches
