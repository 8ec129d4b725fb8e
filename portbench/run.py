"""Run one cell of the port's benchmark once, on one CUDA device.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is ``portbench/workloads/<cell>.json``
(its configuration, the resolution of every render, the driver, the batch,
the IHT_* knobs it sets, its traffic, check and profile); the
configuration is ``portbench/configs/<config>.json`` (the scene document,
frozen here); the driver is ``portbench/drivers/<driver>.py`` (default
``engine``: the batch loop; ``server``: the GUI's Server), each metric
``portbench/metrics/<metric>.py``; which metrics a cell reports is read
from ``BENCHMARK.json``. A new cell, configuration, driver or metric is a
new file and an entry there: nothing in this file names one.

The driver does the timed path in this fresh process: the set-up, which
ends ``setup_s``; the window of ``--seconds``; after it the peak device
memory and, with ``--trace 1``, a profiled stretch (``profiler.py``) and
what the per-layer readers measure while the program lives; then the
check, in which the plain reference (``reference/``, by default
``scene``) works out again, from the configuration and the seed, what the
timed path produced (its docstring says what is compared and when).

The last line of standard output is one JSON object: ``correct``,
``attempted`` (the window's units of work: batches, commits), ``failed``,
``metrics``, ``device`` and with ``--trace 1`` ``breakdown``, then
``checks``: each number compared, with its limit. The numbers compared
are also the last lines of standard error. Without a CUDA device, or with
fewer than the cell's chips, the run prints no result and exits with 2; if
jax, jaxlib, flax or the JAX package are loaded when the window has closed,
with 3.

``--control`` (never in the benchmark's own runs) puts the cell's control
in the program's place: the program with the cell's ``control`` knobs, or
the reference folding bfloat16 rows; it has to come out not correct.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from portbench.drivers import Ctx, Job, log  # noqa: E402,F401  (Ctx: what a metric reads)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "ice_halo_sim_tpu")
NAME = 160   # characters kept of an operation's name in the breakdown


def load(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def spec() -> dict:
    return load(ROOT, "BENCHMARK.json")


def workload(name: str) -> dict:
    return load(HERE, "workloads", f"{name}.json")


def config(name: str) -> dict:
    return load(HERE, "configs", f"{name}.json")


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """(name, unit) of the metrics this cell reports in a run: the
    end-to-end ones without trace, the per-layer ones with it."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [(m["name"], m["unit"]) for m in group if cell in m.get("workloads", [cell])]


def scene_document(wl: dict, cfg: dict) -> dict:
    """The configuration's scene at the cell's resolution of every render."""
    doc = copy.deepcopy(cfg["document"])
    if len(wl["resolution"]) != len(doc["render"]):
        raise ValueError(f"{wl['name']}: {len(wl['resolution'])} resolutions for "
                         f"{len(doc['render'])} renders")
    for render, res in zip(doc["render"], wl["resolution"]):
        render["resolution"] = list(res)
    return doc


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, control: bool = False,
             device: str = "cuda", **test) -> dict:
    """One run of one cell: the result line as a dict (module docstring).
    The cell's driver does the set-up, the window, the profile and the
    check; `test` goes to it whole (the CPU tests' plain kernels, small
    sizes and planted faults: the driver's docstring names them)."""
    bench = spec()
    wl = workload(cell)
    doc = scene_document(wl, config(wl["config"]))
    knobs = dict(wl.get("knobs", {}))
    if control and wl["control"]["kind"] == "program":
        knobs.update(wl["control"]["knobs"])
    os.environ.update({k: str(v) for k, v in knobs.items()})
    names = cell_metrics(bench, cell, trace)
    readers = {n: importlib.import_module(f"portbench.metrics.{n}") for n, _ in names}
    driver = importlib.import_module(f"portbench.drivers.{wl.get('driver', 'engine')}")
    job = Job(cell=cell, wl=wl, doc=doc, seed=seed, seconds=seconds, trace=trace,
              control=control, device=device, readers=readers, t0=T0, test=test)
    ctx, checks, failed, dev = driver.run(job)
    out = result(ctx, names, readers, checks, failed, dev)
    for k, (v, lim) in checks.items():
        log(f"check {k} {v!r} limit {lim!r}")
    return out


def result(ctx, names, readers, checks, failed, dev) -> dict:
    """The result line: ``correct``, ``attempted``, ``failed``, ``metrics``
    (each metric its reader gave a value), ``device`` (with the profiled
    window's busy and wall seconds in a traced run), ``breakdown`` in a
    traced run, and ``checks`` last: {name: (value, limit)} as given.
    ``correct``: no failed unit and no number over its limit."""
    metrics = {}
    for name, unit in names:
        value = readers[name].read(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    correct = failed == 0 and all(v <= lim for v, lim in checks.values())
    out = {"correct": correct, "attempted": ctx.attempted, "failed": failed,
           "metrics": metrics, "device": dict(dev)}
    p = ctx.profile
    if p is not None:
        out["device"]["busy_s"] = p.busy_s()
        out["device"]["window_s"] = p.wall_s
        out["breakdown"] = {"device_ops": [[n[:NAME], v] for n, v in p.top_ops(10)],
                            "idle_gaps": [[n[:NAME], v] for n, v in p.idle_gaps(10)]}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    chips = workload(args.workload)["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), args.control)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of jax or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
