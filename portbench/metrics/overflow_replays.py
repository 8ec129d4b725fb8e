"""overflow_replays (program counter, replays per 1000 batches): the
batches of the window that overflowed a compacted branch and were run again
eagerly (``Engine.overflow_replays``), per 1000 batches of the window. Each
replay restores a snapshot and runs part of a dispatch again, eagerly: time
that the window's rate pays."""


def read(ctx):
    w = ctx.window
    if w.get("overflow_replays") is None or not w["batches"]:
        return None
    return 1e3 * w["overflow_replays"] / w["batches"]
