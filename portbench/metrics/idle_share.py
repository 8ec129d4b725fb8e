"""idle_share (device trace): the share of the profiled window of graph
replays in which nothing ran on the device, on the device's own timeline:
1 - busy / span, where busy is the seconds in which some operation ran and
span the seconds from the first operation's start to the last one's end.
Both come from the one trace, so the share lies in [0, 1). The gaps that
the profiler itself opens between replays count in it (the breakdown's
``idle_gaps`` names them by what the host was doing)."""


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    span = p.device_span_s()
    if not span > 0:
        raise RuntimeError(f"idle_share: a device span of {span} s in the profiled window")
    return 1.0 - p.busy_s() / span
