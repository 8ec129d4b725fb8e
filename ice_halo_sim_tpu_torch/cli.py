"""Command-line renderer of the port: project JSON -> one PNG per render.

    python -m ice_halo_sim_tpu_torch.cli scene.json -o out/ --device cuda
    python -m ice_halo_sim_tpu_torch.cli --scene ms -o out/ --ray-num 2000000

Any scene the engine renders: the trace kernel path where it takes the scene,
the general trace path otherwise (several layers or settings, filters, colour
classes, every lens). ``--scene`` picks one of the built-in full-width scenes
of scenes.py instead of a file. A scene with colour classes also writes the
class composite. ``--draw-overlays`` rasterises the render's grid lines and
celestial outline onto the PNGs; ``--benchmark`` prints one [BENCHMARK] JSON
line with the steady rays/s instead of writing images.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="ice-halo renderer (PyTorch/CUDA port)")
    parser.add_argument("config", nargs="?", default=None, help="project JSON file")
    parser.add_argument("--scene", default=None, choices=("bench", "pool", "ms", "color"),
                        help="a built-in scene of scenes.py instead of a file")
    parser.add_argument("-o", "--output", default=".", help="output directory")
    parser.add_argument("--ray-num", type=int, default=None, help="override scene ray_num")
    parser.add_argument("--seed", type=int, default=None,
                        help="RNG seed (default: IHT_SEED env knob, else 1)")
    parser.add_argument("--batch-size", type=int, default=None,
                        help="rays per batch (default: IHT_BATCH_SIZE env knob, "
                             "else 229376 on cuda, 16384 on cpu)")
    parser.add_argument("--geom-clock", type=int, default=None,
                        help="rays per sampled crystal shape (default: "
                             "IHT_GEOM_CLOCK env knob, else 32; a stochastic "
                             "shape needs 128 and moves the default there)")
    parser.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    parser.add_argument("--kernels", default=None, choices=("cuda", "plain"),
                        help="kernel set (default: cuda on a CUDA device, else plain)")
    parser.add_argument("--benchmark", action="store_true",
                        help="measure steady-state rays/s and print [BENCHMARK] JSON")
    parser.add_argument("--draw-overlays", action="store_true",
                        help="rasterize grid lines / celestial outline onto outputs "
                             "(display-time overlays)")
    args = parser.parse_args(argv)

    import torch

    from ice_halo_sim_tpu_torch import scenes
    from ice_halo_sim_tpu_torch.config.loader import load_project, load_project_file
    from ice_halo_sim_tpu_torch.utils import env_knobs
    from ice_halo_sim_tpu_torch.core.color import linear_to_srgb
    from ice_halo_sim_tpu_torch.utils.png import write_png
    from ice_halo_sim_tpu_torch.engine.simulator import Engine

    if (args.config is None) == (args.scene is None):
        print("give a project JSON file or --scene, not both", file=sys.stderr)
        return 2
    if args.scene is not None:
        cfg = load_project(getattr(scenes, args.scene.upper() + "_CFG"))
    else:
        cfg = load_project_file(args.config)
    total = args.ray_num if args.ray_num is not None else cfg.scene.ray_num
    if total < 0 and args.benchmark:
        total = None                # an infinite scene: whole dispatches
    elif total <= 0:
        print("a positive ray_num (or --ray-num) is required", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    seed = args.seed if args.seed is not None else env_knobs.get("IHT_SEED", 1)
    geom_clock = (args.geom_clock if args.geom_clock is not None
                  else env_knobs.get("IHT_GEOM_CLOCK", 32))
    batch = args.batch_size or env_knobs.get("IHT_BATCH_SIZE") or (
        112 * 2048 if device.type == "cuda" else 1 << 14
    )
    if total is not None:
        batch = min(batch, max(2048, -(-total // 2048) * 2048))

    t0 = time.time()
    engine = Engine(cfg, seed=seed, batch_size=batch, device=device,
                    kernels=args.kernels, geom_clock=geom_clock)
    if args.benchmark:
        return _benchmark(engine, total, t0)
    engine.run(total_rays=total)
    stats = engine.drain_stats()
    print(f"simulated {stats.rays_traced} rays in {time.time() - t0:.1f}s "
          f"({engine.trace_path}, {device})")
    print(f"fold: {engine.fold_kind} ({engine.fold_decision})")

    os.makedirs(args.output, exist_ok=True)
    stem = args.scene or os.path.splitext(os.path.basename(args.config))[0]
    for r, (img, rcfg) in enumerate(zip(engine.snapshot(), cfg.renders)):
        if args.draw_overlays:
            from ice_halo_sim_tpu_torch.engine.overlay import draw_overlays_u8

            img = draw_overlays_u8(img, rcfg, engine.proj_plans[r],
                                   cfg.light.sun.azimuth, cfg.light.sun.altitude)
        out_path = os.path.join(args.output, f"{stem}_render{rcfg.id}.png")
        write_png(out_path, img)
        print("wrote", out_path)
        comp = engine.composite(r)
        if comp is not None:
            out_path = os.path.join(args.output, f"{stem}_render{rcfg.id}_classes.png")
            srgb = linear_to_srgb(torch.as_tensor(comp, dtype=torch.float32))
            write_png(out_path, (srgb * 255.0).to(torch.uint8).numpy())
            print("wrote", out_path)
    return 0


def _benchmark(engine, total, t0: float) -> int:
    """The JAX CLI's [BENCHMARK] line: setup (build, calibration, one
    dispatch) excluded from the rate; a finite budget times ceil(total /
    batch) batches, an infinite one ten whole dispatches."""
    import torch

    device = engine.device

    def hard_sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    batch, spd = engine.batch_size, engine.steps_per_dispatch
    engine.run(n_batches=1)
    engine.run(n_batches=spd)
    hard_sync()
    setup_sec = time.time() - t0
    t1 = time.time()
    if total is None:
        n_windows = 10
        for _ in range(n_windows):
            engine.run(n_batches=spd)
            hard_sync()
        active_sec = time.time() - t1
        rays = n_windows * spd * batch
        rate_basis = "drain_aligned"
    else:
        n_timed = max(1, -(-total // batch))
        engine.run(n_batches=n_timed)
        hard_sync()
        active_sec = time.time() - t1
        rays = n_timed * batch
        rate_basis = "steady" if active_sec >= 1.0 else "active_short"
    wall_sec = time.time() - t0
    print("[BENCHMARK] " + json.dumps({
        "mode": "multi",
        "workers": 1,
        "cores": os.cpu_count(),
        "rays": rays,
        "wall_sec": round(wall_sec, 3),
        "setup_sec": round(setup_sec, 3),
        "active_sec": round(active_sec, 3),
        "rays_per_sec": round(rays / active_sec, 1),
        "rate_basis": rate_basis,
        "batch_size": batch,
        "platform": device.type,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
