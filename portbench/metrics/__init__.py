"""One file per metric of ``BENCHMARK.json``, found by the metric's name.

Each holds ``read(ctx)``, which returns the metric's value or None when
the run gave it nothing to read (the harness then leaves the metric out),
and may hold ``measure(engine, ctx)``, which a traced run calls while the
port's engine is still alive, after the profiled window. ``ctx`` is the
run's record (``run.Ctx``). Files whose name starts with ``_`` are shared
arithmetic, not metrics.
"""
