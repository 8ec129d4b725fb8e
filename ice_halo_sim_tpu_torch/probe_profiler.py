"""Probe: CUDA-graph replays inside torch.profiler windows.

    python -m ice_halo_sim_tpu_torch.probe_profiler [--runs 20] [--jobs 3]
        [--before DIR] [--parent DIR] [--only NAME,...] [--log-dir DIR] [--list]

Each experiment runs `--runs` times, each run a child process of its own,
so that a crash is counted and is not the probe's exit; `--jobs` children
run at once on the card. One JSON line per experiment: its runs, how many
crashed (the child died of a signal), how many failed otherwise, how many
passed, and the signals seen. The end of each run's output and standard
error (a crash's faulthandler frames) go to `--log-dir`.

Two kinds of experiment:

- **toy**: plain torch, none of the port's modules but ``utils.profiling``:
  a body of TOY_OPS small kernels (about an MS_CFG batch) runs eagerly
  inside one profiler window, is captured as a CUDA graph after that
  window, replayed once outside a window, then replayed inside the next
  one; "toy-destroy" first captures, replays and drops another graph
  between the windows.
- **cut**: ``chip_smoke.main()`` of a checkout, cut after [4]'s first fold
  verdict (MS_CFG's auto, sort and sandwich engines, each steady batch a
  graph replay), which times under the profiler (``chip_smoke._time_ms``)
  as it did when it crashed; the run passes when it gets past that verdict.
  `--before DIR` is a checkout of the port before the repair (its
  ``_fold_verdict`` timed with CUDA events, and the cut run puts it back
  under the profiler), `--parent DIR` one of that checkout's parent. The
  verdict left ``chip_smoke.py`` with the fold it timed, so a cut runs only
  on such a checkout; an experiment whose checkout was not given is listed
  as not run.

Environment settings are given to a child explicitly, the old value where
an experiment repeats the state before the repair.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOY_OPS = 5000

# The cut run: chip_smoke.main() up to the end of [4]'s first fold verdict.
# TREE, FRESH and WINDOW_FIRST are set by the probe.
_CUT = r"""
import faulthandler, os, sys
faulthandler.enable()
sys.path.insert(0, TREE)
os.chdir(TREE)
import chip_smoke as c
if WINDOW_FIRST:
    import importlib.util
    spec = importlib.util.spec_from_file_location("_profiling", HELPER)
    prof = importlib.util.module_from_spec(spec)
    from ice_halo_sim_tpu_torch.engine import graph as g
    if not hasattr(g, "invalidate"):
        g.invalidate = lambda: None   # a checkout before the repair marks nothing stale
    spec.loader.exec_module(prof)
    with prof.device_profile():
        pass
if hasattr(c, "_event_ms"):
    # The checkout before the repair timed the verdict with CUDA events.
    c._event_ms = lambda fn, reps: c._time_ms(fn, reps, "fold verdict")
verdict = c._fold_verdict
def once(what, chosen, engines, *a, **k):
    if FRESH:
        for e in engines.values():
            e._graph = None   # captured again by the timing's warm-up call
    verdict(what, chosen, engines, *a, **k)
    import torch
    print(f"PAST_THE_VERDICT; peak reserved {torch.cuda.max_memory_reserved()} bytes", flush=True)
    sys.stdout.flush()
    os._exit(0)
c._fold_verdict = once
sys.exit(c.main())
"""

# name: (description, kind, checkout or variant, environment)
EXPERIMENTS = {
    "toy": ("plain torch: one window, a capture, a replay in the next window",
            "toy", "plain", {}),
    "toy-destroy": ("the same, a graph captured, replayed and dropped before the capture",
                    "toy", "destroy", {}),
    "before": ("the cut run before the repair", "cut", "before", {}),
    "parent": ("the cut run on the parent of the checkout before the repair",
               "cut", "parent", {}),
    "before-eager-modules": ("before the repair, CUDA_MODULE_LOADING=EAGER", "cut", "before",
                             {"CUDA_MODULE_LOADING": "EAGER"}),
    "before-window-first": ("before the repair, one window opened and closed before the "
                            "first capture", "cut", "before+window", {}),
    "before-fresh-capture": ("before the repair, the engines' graphs captured again just "
                             "before the window", "cut", "before+fresh", {}),
    "before-no-teardown": ("before the repair, TEARDOWN_CUPTI=0 and "
                           "DISABLE_CUPTI_LAZY_REINIT=1", "cut", "before",
                           {"TEARDOWN_CUPTI": "0", "DISABLE_CUPTI_LAZY_REINIT": "1"}),
}


def toy(variant: str) -> int:
    """One toy run (in a child): see the module docstring. `variant`
    "destroy" captures, replays and drops a graph between the windows."""
    import faulthandler

    import torch

    from ice_halo_sim_tpu_torch.utils.profiling import device_profile

    faulthandler.enable()
    dev = torch.device("cuda", 0)
    x = torch.zeros(4096, device=dev)

    def body():
        y = x
        for _ in range(TOY_OPS // 2):
            y = y.mul(0.5).add(1.0)
        x.copy_(y)

    def capture():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            body()
        return g

    with device_profile():
        body()
        torch.cuda.synchronize()
    if variant == "destroy":
        old = capture()
        old.replay()
        torch.cuda.synchronize()
        del old
    g = capture()
    g.replay()
    torch.cuda.synchronize()
    with device_profile() as win:
        for _ in range(3):
            g.replay()
        torch.cuda.synchronize()
    print(json.dumps({"toy": variant, "device_us": win.device_us, "kernels": win.kernels}),
          flush=True)
    return 0


def _command(kind: str, where: str, trees: dict):
    """(argv, cwd) of one run, or None when its checkout was not given."""
    if kind == "toy":
        return [sys.executable, "-m", "ice_halo_sim_tpu_torch.probe_profiler",
                "--toy", where], ROOT
    tree_name, _, extra = where.partition("+")
    tree = trees.get(tree_name)
    if tree is None:
        return None
    code = (f"TREE = {tree!r}\nFRESH = {extra == 'fresh'}\n"
            f"WINDOW_FIRST = {extra == 'window'}\n"
            f"HELPER = {os.path.join(ROOT, 'ice_halo_sim_tpu_torch', 'utils', 'profiling.py')!r}\n"
            + _CUT)
    return [sys.executable, "-c", code], tree


def _one(argv, cwd, env, timeout: float):
    """(outcome, returncode, tail of its output) of one child."""
    try:
        out = subprocess.run(argv, cwd=cwd, env=env, capture_output=True, text=True,
                             timeout=timeout)
    except subprocess.TimeoutExpired as e:
        return "failed", None, f"timed out after {timeout} s\n{(e.stderr or '')[-4000:]}"
    tail = f"{out.stdout[-2000:]}\n--- stderr\n{out.stderr[-6000:]}"
    if out.returncode < 0:
        return "crashed", out.returncode, tail
    return ("failed" if out.returncode else "passed"), out.returncode, tail


def run_experiment(name: str, runs: int, jobs: int, trees: dict, log_dir, timeout: float):
    """Its JSON line's fields (see the module docstring)."""
    what, kind, where, env_add = EXPERIMENTS[name]
    cmd = _command(kind, where, trees)
    row = {"experiment": name, "what": what, "env": env_add}
    if cmd is None:
        return {**row, "runs": 0, "not_run": f"no checkout given for {where.split('+')[0]}"}
    env = dict(os.environ, PYTHONPATH=cmd[1], OMP_NUM_THREADS="2", **env_add)
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=jobs) as pool:
        results = list(pool.map(lambda _: _one(*cmd, env, timeout), range(runs)))
    counts = {k: sum(r[0] == k for r in results) for k in ("crashed", "failed", "passed")}
    signals = sorted({-r[1] for r in results if r[0] == "crashed"})
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        for i, (outcome, rc, tail) in enumerate(results):
            with open(os.path.join(log_dir, f"{name}.{i}.{outcome}.txt"), "w") as f:
                f.write(f"returncode {rc}\n{tail}")
    return {**row, "runs": runs, **counts, "signals": signals,
            "seconds": round(time.time() - t0, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--before", default=None, help="a checkout of the port before the repair")
    ap.add_argument("--parent", default=None, help="a checkout of that checkout's parent")
    ap.add_argument("--only", default=None, help="comma-separated experiment names")
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds per run")
    ap.add_argument("--list", action="store_true", help="list the experiments and exit")
    ap.add_argument("--toy", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.toy is not None:
        return toy(args.toy)
    names = list(EXPERIMENTS) if args.only is None else args.only.split(",")
    unknown = [n for n in names if n not in EXPERIMENTS]
    if unknown:
        ap.error(f"unknown experiments {unknown}; --list lists them")
    if args.list:
        for n in names:
            what, kind, where, env = EXPERIMENTS[n]
            print(f"{n}: {kind} ({where}) {what}{' ' + json.dumps(env) if env else ''}")
        return 0
    import torch

    if not torch.cuda.is_available():
        print("probe_profiler: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, cuda {torch.version.cuda}", flush=True)
    trees = {k: v and os.path.abspath(v) for k, v in (("before", args.before),
                                                       ("parent", args.parent))}
    for d in [ROOT] + [t for t in trees.values() if t]:
        # Build each checkout's kernels once, before its children share them.
        subprocess.run([sys.executable, "-c", "from ice_halo_sim_tpu_torch.kernels import "
                        "build; build.build()"], cwd=d, env=dict(os.environ, PYTHONPATH=d),
                       check=True, timeout=900)
    for n in names:
        print(json.dumps(run_experiment(n, args.runs, args.jobs, trees, args.log_dir,
                                        args.timeout)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
