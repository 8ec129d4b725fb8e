"""setup_program_s (program span, s): the part of set-up that is the
program's own work: the union of the process's first ``iht.setup.engine``
(``Engine.__init__``), ``iht.setup.library`` (the kernel library's load, its
build included), ``iht.calibrate`` (the calibration after the first
dispatch, its host read included) and ``iht.capture`` (the batch's warm-up
and capture) spans. The rest of ``setup_s`` is imports, CUDA's start-up and
the calibrating batch. On the CPU there is no library and no capture."""

from portbench.metrics import _program
from portbench.metrics._program import measure  # noqa: F401

NAMES = ("iht.setup.engine", "iht.setup.library", "iht.calibrate", "iht.capture")


def read(ctx):
    rec = _program.record(ctx)
    if rec is None:
        return None
    first = {}
    for s in rec["snapshot"]["spans"]:
        if s.name in NAMES and s.name not in first:
            first[s.name] = s
    need = NAMES if rec["card"] else ("iht.setup.engine", "iht.calibrate")
    missing = [n for n in need if n not in first]
    if missing:
        if rec["card"]:
            raise RuntimeError(f"setup_program_s: no {missing} span on the card")
        return None
    total, end = 0, None
    for s in sorted(first.values(), key=lambda s: s.start):
        lo = s.start if end is None else max(s.start, end)
        if s.end > lo:
            total += s.end - lo
        end = s.end if end is None else max(end, s.end)
    return total * 1e-9
