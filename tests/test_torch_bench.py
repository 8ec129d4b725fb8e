"""The port's bench entry (``python -m ice_halo_sim_tpu_torch.bench``) on
the CPU with the plain kernels: five windows of about a second at batch
4096 and four batches per dispatch; its one JSON line carries bench.py's
keys and the added ones."""

import json

import torch

from ice_halo_sim_tpu_torch import bench

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "rays", "seconds", "batch_size",
              "resolution", "platform", "max_hits", "fold", "fold_decision", "trace_path"}
ADDED = {"windows", "median", "cov", "host_syncs_per_batch", "host_syncs_per_dispatch",
         "overflow_replays", "graph_mode", "steps_per_dispatch", "card"}


def test_bench_entry_line(monkeypatch, capsys):
    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", "4")
    rc = bench.main(["--device", "cpu", "--kernels", "plain", "--window", "1",
                     "--windows", "5", "--batch-size", "4096"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert BENCH_KEYS | ADDED <= set(line)
    assert line["platform"] == "cpu" and line["unit"] == "rays/s" and line["card"] is None
    assert line["metric"] == "light_single_ms_rays_per_sec_per_chip"
    assert line["resolution"] == [512, 256] and line["max_hits"] == 7
    assert line["batch_size"] == 4096 and line["steps_per_dispatch"] == 4
    assert line["trace_path"] == "plain-torch" and line["fold"] == "sort"
    assert len(line["windows"]) == 5 and line["value"] == line["median"] > 0
    assert line["vs_baseline"] == line["value"] / bench.BASELINE_CPU_RAYS_PER_SEC
    assert line["rays"] % (4 * 4096) == 0 and line["cov"] >= 0.0
    # Steady dispatches: one host read each, none per batch.
    assert line["host_syncs_per_dispatch"] == 1.0 and line["host_syncs_per_batch"] == 0.25
    assert line["overflow_replays"] == 0 and line["graph_mode"] == "eager (graphs off)"
