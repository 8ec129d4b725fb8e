"""setup_s (host clock): from the start of the harness's process (its first
statement; the interpreter's own start-up, some tens of milliseconds, is
not counted) to the end of the warm-up: imports, the kernel library's load
(its build too, in a checkout's first run), the Engine, the calibrating
batch and one full dispatch, which captures the CUDA graph."""


def read(ctx):
    return ctx.setup_s
