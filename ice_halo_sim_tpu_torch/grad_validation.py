"""Shape-gradient validation of the port's differentiable render (twin of
``scripts/grad_validation.py``), on torch autograd.

  table   Seed-averaged autodiff against finite differences per
          differentiable parameter. Ground truth: the central FD of the
          hard render with common random numbers, averaged over seeds; the
          estimate: autodiff of the soft_tau render (REINFORCE entry term
          and, for the shape parameters, the softmin face boundary
          estimator). Reports |grad - FD| / |FD| with Monte-Carlo standard
          errors.
  demo    Inverse rendering: recover a perturbed prism height by gradient
          descent on an L2 loss against a blurred target image.

    python -m ice_halo_sim_tpu_torch.grad_validation table [--rays 50000000] [--batch 65536]
    python -m ice_halo_sim_tpu_torch.grad_validation demo [--iters 60]

One JSON line per result, each naming the device (and on a CUDA device the
card's name and power limit); exit 0 iff every acceptance bound holds. The
device is CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# The tilted-plate scene of the JAX package's gradient tests: the slab
# face reassignment boundary carries most of the prism height gradient
# there, so a wrong boundary estimator cannot hide.
TILTED_DOC = {
    "crystal": [
        {"id": 1, "type": "prism", "shape": {"height": 0.9},
         "axis": {"zenith": {"type": "gauss", "mean": 62, "std": 0.5},
                  "azimuth": {"type": "uniform", "mean": 0, "std": 360}}}
    ],
    "filter": [],
    "scene": {
        "light_source": {"type": "sun", "altitude": 25,
                         "spectrum": [{"wavelength": 550, "weight": 1.0}]},
        "ray_num": 10000, "max_hits": 6,
        "scattering": [{"prob": 0.0,
                        "entries": [{"crystal": 1, "proportion": 1}]}],
    },
    "render": [{"id": 1, "lens": {"type": "fisheye_equal_area", "fov": 165},
                "resolution": [96, 96], "view": {"elevation": 90},
                "visible": "full"}],
}


def tilted_cfg():
    from ice_halo_sim_tpu_torch.config.loader import load_project

    return load_project(TILTED_DOC)


def box_blur(y, k: int):
    """k x k box mean with zero padding, 'same' size: a 2-D convolution by a
    symmetric box kernel (pooling, so no reduced-precision conv path)."""
    return F.avg_pool2d(y[None, None], k, stride=1, padding=k // 2,
                        count_include_pad=True)[0, 0]


def smooth_loss(img):
    """Blurred-image L2 against zero: two 7 x 7 box passes (sigma about
    2.3 px), wide enough that central finite differences of the direction
    parameters converge."""
    sm = box_blur(box_blur(img.sum(-1), 7), 7)
    return torch.sum(sm * sm) * 1e-3


def _rep(field):
    return lambda p, v: p._replace(**{field: v})


def _rep_face_d0(p, v):
    return p._replace(face_distance=torch.cat([v.reshape(1), p.face_distance[1:]]))


# (name, replace_fn, fd_eps, soft_tau of the gradient render): the JAX
# script's values.
PARAMS = [
    ("sun_altitude_deg", _rep("sun_altitude_deg"), 0.04, None),
    ("zenith_mean_deg", _rep("zenith_mean_deg"), 0.04, None),
    ("zenith_std_deg", _rep("zenith_std_deg"), 0.10, None),
    ("height", _rep("height"), 0.03, 0.005),
    ("face_d0", _rep_face_d0, 0.03, 0.005),
]


def card(dev: torch.device) -> dict:
    """The device of a result line: its type, and on CUDA the card's name
    and power limit as nvidia-smi gives them."""
    out = {"device": dev.type}
    if dev.type == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    return out


def run_table(rays: int, batch: int, device="cuda") -> int:
    from ice_halo_sim_tpu_torch.engine.gradient import (default_params, make_render_fn,
                                                        resolve_device)

    dev = resolve_device(device)
    cfg = tilted_cfg()
    params = default_params(cfg, dev)
    n_seeds = max(4, rays // batch)
    where = card(dev)
    print(json.dumps({"scene": "tilted_prism_96px", "batch": batch, "seeds": n_seeds,
                      "total_rays": n_seeds * batch, **where}), flush=True)
    ok = True
    t_all = time.time()
    for name, rep, eps, tau in PARAMS:
        v0 = float(params.face_distance[0] if name == "face_d0" else getattr(params, name))
        t0 = time.time()
        hard = make_render_fn(cfg, batch_size=batch, seed_as_arg=True, device=dev)
        soft = (make_render_fn(cfg, batch_size=batch, soft_tau=tau, seed_as_arg=True,
                               device=dev) if tau else hard)
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
        gs, lps, lms = [], [], []
        for s in range(n_seeds):
            sd = 1000 + s
            v = f32(v0).requires_grad_(True)
            (g,) = torch.autograd.grad(smooth_loss(soft(rep(params, v), sd)), v)
            gs.append(g)
            with torch.no_grad():
                lps.append(smooth_loss(hard(rep(params, f32(v0 + eps)), sd)))
                lms.append(smooth_loss(hard(rep(params, f32(v0 - eps)), sd)))
        grads = torch.stack(gs).double().cpu().numpy()
        fds = ((torch.stack(lps).double() - torch.stack(lms).double()) / (2 * eps)).cpu().numpy()
        g, fd = float(np.mean(grads)), float(np.mean(fds))
        se_g = float(np.std(grads) / np.sqrt(len(grads)))
        se_fd = float(np.std(fds) / np.sqrt(len(fds)))
        rel = abs(g - fd) / max(abs(fd), 1e-12)
        # |g - fd| within 15% of |fd| or within 3 combined standard errors
        # (the Monte-Carlo noise floor at this N), and the same sign.
        bound = max(0.15 * abs(fd), 3.0 * (se_g + se_fd))
        passed = abs(g - fd) <= bound and np.sign(g) == np.sign(fd)
        ok &= bool(passed)
        print(json.dumps({
            "param": name, "autodiff": g, "fd_hard": fd,
            "rel_err": round(rel, 4), "se_grad": se_g, "se_fd": se_fd,
            "soft_tau": tau, "fd_eps": eps,
            "rays": n_seeds * batch, "pass": bool(passed),
            "wall_s": round(time.time() - t0, 1), **where,
        }), flush=True)
    print(json.dumps({"table_wall_s": round(time.time() - t_all, 1), "pass": bool(ok),
                      **where}), flush=True)
    return 0 if ok else 1


def run_demo(iters: int, batch: int, device="cuda") -> int:
    """Recover a perturbed prism height by gradient descent (Adam on the
    soft_tau estimator's gradient, a fresh seed per step) on a target
    rendered with the same estimator at the true height."""
    from ice_halo_sim_tpu_torch.engine.gradient import (default_params, make_render_fn,
                                                        resolve_device)

    dev = resolve_device(device)
    cfg = tilted_cfg()
    params = default_params(cfg, dev)
    h_true = float(params.height)
    where = card(dev)

    # Heavily blurred: the raw image L2 over displaced halo rings is not
    # convex in the shape parameters; the blur widens the basin.
    def blur(img):
        y = img.sum(-1)
        for _ in range(3):
            y = box_blur(y, 9)
        return y

    fn = make_render_fn(cfg, batch_size=batch, soft_tau=0.01, seed_as_arg=True, device=dev)
    with torch.no_grad():
        target = sum(fn(params, 500 + s) for s in range(8))
        target = blur(target / 8.0)

    h = h_true - 0.12          # the perturbed start
    m = v = 0.0
    lr0, b1, b2 = 0.02, 0.8, 0.95
    tail = []
    t0 = time.time()
    for it in range(iters):
        hv = torch.tensor(h, dtype=torch.float32, device=dev, requires_grad=True)
        loss = torch.sum((blur(fn(params._replace(height=hv), 9000 + it)) - target) ** 2) * 1e-3
        (g,) = torch.autograd.grad(loss, hv)
        g = float(g)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - b1 ** (it + 1))
        vh = v / (1 - b2 ** (it + 1))
        # Cosine decay and tail averaging against the Monte-Carlo noise.
        lr = lr0 * (0.5 + 0.5 * np.cos(np.pi * it / iters))
        h -= lr * mh / (np.sqrt(vh) + 1e-8)
        if it >= iters - 20:
            tail.append(h)
        if it % 10 == 0:
            print(json.dumps({"iter": it, "height": round(h, 5), "grad": g}), flush=True)
    h = float(np.mean(tail))
    err = abs(h - h_true)
    print(json.dumps({
        "demo": "height_recovery", "h_true": h_true, "h_start": h_true - 0.12,
        "h_final": round(h, 5), "abs_err": round(err, 5),
        "iters": iters, "rays_per_iter": batch,
        "wall_s": round(time.time() - t0, 1),
        "pass": bool(err < 0.02), **where,
    }), flush=True)
    return 0 if err < 0.02 else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["table", "demo"])
    ap.add_argument("--rays", type=int, default=50_000_000)
    ap.add_argument("--batch", type=int, default=1 << 16)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mode == "table":
        return run_table(args.rays, args.batch, args.device)
    return run_demo(args.iters, args.batch, args.device)


if __name__ == "__main__":
    sys.exit(main())


# --- The port against the JAX package's render ------------------------------
# tests/data/torch_port_grad_ref.npz (scripts/make_torch_port_ref.py grad):
# the tilted scene at seed 3, batch 16384. The tolerances hold on the CPU
# against the live JAX function (tests/test_torch_gradient_jax.py) and
# against the file (tests/test_torch_gradient.py, and chip_smoke.py [7] on
# the card). "The card" below is an NVIDIA H100 80GB HBM3 at 700 W.
FIXTURE = "tests/data/torch_port_grad_ref.npz"
# Rays whose recorded choices (entry triangle, faces, alive, TIR, emit) may
# differ: a hit on a face edge or at the TIR limit decided by the last bit
# of a sin, cos or log, which differ between XLA, torch on the CPU and CUDA.
# Measured: 0 of 16384 at the file's seed on the CPU and on the card; 0 and
# 1 of 16384 between the CPU and the card at other seeds.
FLIP_RAYS = 8
# The frozen render (every decision the file's) and the hard render are held
# per pixel to the engine's tolerance: rtol, atol = frac * the image's max.
IMG_RTOL, IMG_ATOL_FRAC = 1e-4, 1e-6
# The soft_tau image (blended normals and t): relative L1. Measured 1.3e-5
# on the CPU, 1.4e-5 on the card.
IMG_L1 = 1e-3
# Gradients: max |port - JAX| over a field's components over the field's
# largest |JAX gradient| (a field that is 0 in JAX must be 0). Measured on
# the file: frozen 7.0e-5 (CPU) and 2.9e-5 (card), free 7.2e-5 and
# 2.7e-5, soft 2.6e-4 and 3.1e-3: the softmin weighs exit t by
# exp(-dt / tau) with tau = 0.005, which turns the last bit of a t into
# some 1e-3 of a boundary ray's term.
GRAD_RTOL = {"frozen": 1e-3, "free": 1e-3, "soft": 1e-2}


def grad_err(got, want) -> float:
    """max |got - want| over max |want| (0 when both are 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    return d / scale if scale > 0 else (0.0 if d == 0 else float("inf"))


def image_errors(mode: str, got, want) -> dict:
    """The image check of `mode`: pixels off the engine's tolerance (must be
    0) for the hard and frozen renders, the relative L1 for soft."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if mode == "soft":
        l1 = float(np.abs(got - want).sum() / np.abs(want).sum())
        return {"l1": l1, "ok": l1 <= IMG_L1}
    tol = IMG_RTOL * np.abs(want) + IMG_ATOL_FRAC * float(np.abs(want).max())
    off = int((np.abs(got - want) > tol).sum())
    return {"pixels_off": off, "ok": off == 0}


def flipped_rays(got, want) -> int:
    """Rays whose recorded choices differ between two FrozenChoices (numpy
    fields)."""
    differ = np.zeros(np.shape(got[0]), bool)
    for a, b in zip(got, want):
        d = np.asarray(a) != np.asarray(b)
        differ |= d.any(axis=0) if d.ndim == 2 else d
    return int(differ.sum())


def fixture_check(device) -> dict:
    """The port in every mode against the committed JAX render (its base
    params through params_from_jax, its choices through choices_from_jax):
    raises AssertionError on a flip count, an image or a gradient out of
    tolerance; returns the measured errors."""
    import os

    from ice_halo_sim_tpu_torch.engine.gradient import (RenderParams, choices_from_jax,
                                                        make_render_fn, params_from_jax)

    ref = dict(np.load(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), FIXTURE)))
    cfg = tilted_cfg()
    B, seed, tau = int(ref["batch_size"]), int(ref["seed"]), float(ref["soft_tau"])
    params = params_from_jax([ref[f"param_{n}"] for n in RenderParams._fields], device)
    bits = lambda a: np.unpackbits(a, axis=-1, count=B).astype(bool)  # noqa: E731
    want = (ref["entry_sel"], bits(ref["entry_ok"]), ref["faces"], bits(ref["alive"]),
            bits(ref["is_tir"]), bits(ref["emit_ok"]))
    render_frozen, record = make_render_fn(cfg, batch_size=B, seed=seed, frozen_mode=True,
                                           device=device)
    with torch.no_grad():
        got = [c.cpu().numpy() for c in record(params)[1]]
    choices = choices_from_jax(want, device)
    errs = {"flipped_rays": flipped_rays(got, want)}
    bad = [] if errs["flipped_rays"] <= FLIP_RAYS else [f"{errs['flipped_rays']} rays flipped"]
    fns = {"frozen": lambda p: render_frozen(p, choices),
           "free": make_render_fn(cfg, batch_size=B, seed=seed, device=device),
           "soft": make_render_fn(cfg, batch_size=B, seed=seed, soft_tau=tau, device=device)}
    for mode, fn in fns.items():
        p = RenderParams(*(x.detach().clone().requires_grad_(True) for x in params))
        img = fn(p)
        grads = torch.autograd.grad(smooth_loss(img), list(p), allow_unused=True,
                                    materialize_grads=True)
        e = errs[f"{mode}_img"] = image_errors(
            mode, img.detach().cpu().numpy(), ref["img_soft" if mode == "soft" else "img_hard"])
        bad += [] if e["ok"] else [f"{mode} image {e}"]
        for name, g in zip(p._fields, grads):
            e = errs[f"{mode}_grad_{name}"] = grad_err(g.cpu().numpy(),
                                                       ref[f"grad_{mode}_{name}"])
            bad += [] if e <= GRAD_RTOL[mode] else [f"{mode} d/d{name} off by {e:.3g}"]
    if bad:
        raise AssertionError(f"the port against {FIXTURE}: " + "; ".join(bad))
    return errs


def time_modes(batch: int = 1 << 16, device="cuda", reps: int = 10) -> list:
    """Per mode (hard with the score term, soft_tau 0.005, frozen with the
    base point's recorded choices) on the tilted scene: ms per forward (no
    graph, as the finite differences call it) and per forward + backward of
    smooth_loss to all five params (host clock to a synchronise, the median
    of reps calls), device busy time, device kernels and idle share of one
    forward + backward (torch.profiler), and the peak memory allocated."""
    from torch.profiler import ProfilerActivity, profile

    from ice_halo_sim_tpu_torch.engine.gradient import (RenderParams, default_params,
                                                        make_render_fn, resolve_device)

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = tilted_cfg()
    params = default_params(cfg, dev)
    render_frozen, record = make_render_fn(cfg, batch_size=batch, frozen_mode=True, device=dev)
    with torch.no_grad():
        _, choices = record(params)
    fns = {"hard": make_render_fn(cfg, batch_size=batch, device=dev),
           "soft_tau=0.005": make_render_fn(cfg, batch_size=batch, soft_tau=0.005, device=dev),
           "frozen": lambda p: render_frozen(p, choices)}

    def fwd(fn):
        with torch.no_grad():
            return smooth_loss(fn(params))

    def fwd_bwd(fn):
        p = RenderParams(*(x.detach().clone().requires_grad_(True) for x in params))
        return torch.autograd.grad(smooth_loss(fn(p)), list(p), allow_unused=True)

    def wall_ms(call):
        """Median over reps of one call to a synchronise (host-bound calls
        vary with the host's scheduling)."""
        call()
        sync()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            call()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    rows = []
    for mode, fn in fns.items():
        f_ms = wall_ms(lambda: fwd(fn))
        fb_ms = wall_ms(lambda: fwd_bwd(fn))
        row = {"mode": mode, "batch": batch, "fwd_ms": f_ms, "fwd_bwd_ms": fb_ms,
               "rays_per_s": batch / (fb_ms * 1e-3), **card(dev)}
        if cuda:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fwd_bwd(fn)
                sync()
            ev = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
            busy = sum(e.self_device_time_total for e in ev) / 1e3
            torch.cuda.reset_peak_memory_stats(dev)
            fwd_bwd(fn)
            sync()
            row.update(kernels=sum(e.count for e in ev),
                       busy_ms=busy if busy > 0 else None,
                       idle_share=1.0 - busy / fb_ms if busy > 0 else None,
                       peak_mem_bytes=torch.cuda.max_memory_allocated(dev))
        rows.append(row)
    return rows
