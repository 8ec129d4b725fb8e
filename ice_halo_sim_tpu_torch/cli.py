"""Command-line renderer of the port: project JSON -> one PNG per render.

    python -m ice_halo_sim_tpu_torch.cli scene.json -o out/ --device cuda
    python -m ice_halo_sim_tpu_torch.cli --scene ms -o out/ --ray-num 2000000

Any scene the engine renders: the trace kernel path where it takes the scene,
the general trace path otherwise (several layers or settings, filters, colour
classes, every lens). ``--scene`` picks one of the built-in full-width scenes
of scenes.py instead of a file. A scene with colour classes also writes the
class composite.
"""

from __future__ import annotations

import argparse
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
    if total is None or total <= 0:
        print("a positive ray_num (or --ray-num) is required", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    seed = args.seed if args.seed is not None else env_knobs.get("IHT_SEED", 1)
    geom_clock = (args.geom_clock if args.geom_clock is not None
                  else env_knobs.get("IHT_GEOM_CLOCK", 32))
    batch = args.batch_size or env_knobs.get("IHT_BATCH_SIZE") or (
        112 * 2048 if device.type == "cuda" else 1 << 14
    )
    batch = min(batch, max(2048, -(-total // 2048) * 2048))

    t0 = time.time()
    engine = Engine(cfg, seed=seed, batch_size=batch, device=device,
                    kernels=args.kernels, geom_clock=geom_clock)
    engine.run(total_rays=total)
    stats = engine.drain_stats()
    print(f"simulated {stats.rays_traced} rays in {time.time() - t0:.1f}s "
          f"({engine.trace_path}, {device})")

    os.makedirs(args.output, exist_ok=True)
    stem = args.scene or os.path.splitext(os.path.basename(args.config))[0]
    for r, (img, rcfg) in enumerate(zip(engine.snapshot(), cfg.renders)):
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


if __name__ == "__main__":
    sys.exit(main())
