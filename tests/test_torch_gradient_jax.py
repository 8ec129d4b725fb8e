"""The port's differentiable render against the live JAX function on the
CPU (tilted scene of scripts/grad_validation.py, seed 5, batch 4096): the
recorded FrozenChoices; the frozen render fed the JAX package's choices
(choices_from_jax) and base params (params_from_jax); the free render (the
score term) and the soft_tau = 0.005 render, each image and the gradient of
grad_validation's smooth_loss to each of the five params.

Tolerances are grad_validation's (stated and measured there): FLIP_RAYS
rays may differ in their recorded choices; the frozen and hard images are
held per pixel to the engine's tolerance, the soft image by IMG_L1;
gradients to GRAD_RTOL of the field's largest |JAX gradient|.
"""

import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import jax.scipy.signal
import pytest
import torch

from ice_halo_sim_tpu.config.loader import load_project as jax_load_project
from ice_halo_sim_tpu.engine import gradient as jgradient
from ice_halo_sim_tpu_torch import grad_validation as gv
from ice_halo_sim_tpu_torch.engine import gradient

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

B, SEED, TAU = 4096, 5, 0.005
MODES = ("frozen", "free", "soft")


def jax_smooth_loss(img):
    """scripts/grad_validation.py's smooth_loss."""
    k = jnp.ones((7, 7), jnp.float32) / 49.0
    sm = jax.scipy.signal.convolve2d(img.sum(-1), k, mode="same")
    sm = jax.scipy.signal.convolve2d(sm, k, mode="same")
    return jnp.sum(sm * sm) * 1e-3


@pytest.fixture(scope="module")
def both():
    """Images, gradients and recorded choices of both packages."""
    jcfg = jax_load_project(gv.TILTED_DOC)
    jparams = jgradient.default_params(jcfg)
    jfrozen, jrecord = jgradient.make_render_fn(jcfg, batch_size=B, seed=SEED,
                                                frozen_mode=True)
    _, jchoices = jrecord(jparams)
    jfns = {"frozen": lambda p: jfrozen(p, jchoices),
            "free": jgradient.make_render_fn(jcfg, batch_size=B, seed=SEED),
            "soft": jgradient.make_render_fn(jcfg, batch_size=B, seed=SEED, soft_tau=TAU)}

    cfg = gv.tilted_cfg()
    params = gradient.params_from_jax([np.asarray(x) for x in jparams], device="cpu")
    frozen, record = gradient.make_render_fn(cfg, batch_size=B, seed=SEED, frozen_mode=True,
                                             device="cpu")
    choices = gradient.choices_from_jax([np.asarray(c) for c in jchoices], device="cpu")
    fns = {"frozen": lambda p: frozen(p, choices),
           "free": gradient.make_render_fn(cfg, batch_size=B, seed=SEED, device="cpu"),
           "soft": gradient.make_render_fn(cfg, batch_size=B, seed=SEED, soft_tau=TAU,
                                           device="cpu")}
    out = {"jchoices": [np.asarray(c) for c in jchoices]}
    with torch.no_grad():
        out["choices"] = [c.numpy() for c in record(params)[1]]
    for mode in MODES:
        def jloss(p, fn=jfns[mode]):
            img = fn(p)
            return jax_smooth_loss(img), img

        (_, jimg), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
        p = gradient.RenderParams(*(x.clone().requires_grad_(True) for x in params))
        img = fns[mode](p)
        grads = torch.autograd.grad(gv.smooth_loss(img), list(p), allow_unused=True,
                                    materialize_grads=True)
        out[mode] = {"jimg": np.asarray(jimg), "img": img.detach().numpy(),
                     "jgrads": dict(zip(jparams._fields, (np.asarray(g) for g in jgrads))),
                     "grads": dict(zip(p._fields, (g.numpy() for g in grads)))}
    return out


def test_recorded_choices_match_jax(both):
    for a, b in zip(both["choices"], both["jchoices"]):
        assert a.shape == b.shape
    n = gv.flipped_rays(both["choices"], both["jchoices"])
    print(f"{n} of {B} rays differ in their recorded choices")
    assert n <= gv.FLIP_RAYS
    assert both["jchoices"][1].mean() > 0.5 and both["jchoices"][3].any()


@pytest.mark.parametrize("mode", MODES)
def test_image_matches_jax(both, mode):
    r = both[mode]
    assert r["jimg"].sum() > 0
    err = gv.image_errors(mode, r["img"], r["jimg"])
    assert err["ok"], err


@pytest.mark.parametrize("field", gradient.RenderParams._fields)
@pytest.mark.parametrize("mode", MODES)
def test_gradient_matches_jax(both, mode, field):
    got, want = both[mode]["grads"][field], both[mode]["jgrads"][field]
    assert got.shape == want.shape and np.isfinite(got).all()
    err = gv.grad_err(got, want)
    assert err <= gv.GRAD_RTOL[mode], (mode, field, err, got, want)


# --- The table's compiled programs against JAX's jit(grad) -----------------
# grad_validation.table_programs (the port's table: its gradient and loss
# functions per parameter over the captured seed_as_arg programs) at
# batch TABLE_B, the seed passed as a tensor, against the JAX script's own
# composition, jax.jit(jax.grad(lambda v, sd: smooth_loss(soft(rep(params,
# v), sd)))) and jax.jit(lambda v, sd: smooth_loss(hard(rep(params, v), sd))),
# built here from the JAX package's make_render_fn and scripts/
# grad_validation.py's PARAMS and smooth_loss. Gradients within GRAD_RTOL
# (soft_tau: "soft"); the loss within 2 * IMG_RTOL (the hard image's per-pixel
# tolerance, doubled by the square; measured 1.1e-5 at most).

TABLE_B, TABLE_SEEDS = 2048, (1000, 1001)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_grad_validation", os.path.join(ROOT, "scripts", "grad_validation.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("i", range(len(gv.PARAMS)), ids=[p[0] for p in gv.PARAMS])
def test_table_programs_match_jax_jit_grad(jax_script, i):
    jname, jrep, eps, tau = jax_script.PARAMS[i]
    name, rep, eps_port, tau_port = gv.PARAMS[i]
    assert (jname, eps, tau) == (name, eps_port, tau_port)
    jcfg = jax_script.tilted_cfg()
    jparams = jgradient.default_params(jcfg)
    hard = jgradient.make_render_fn(jcfg, batch_size=TABLE_B, seed_as_arg=True)
    soft = (jgradient.make_render_fn(jcfg, batch_size=TABLE_B, soft_tau=tau, seed_as_arg=True)
            if tau else hard)
    jgrad = jax.jit(jax.grad(lambda v, sd: jax_script.smooth_loss(soft(jrep(jparams, v), sd))))
    jloss = jax.jit(lambda v, sd: jax_script.smooth_loss(hard(jrep(jparams, v), sd)))

    params = gradient.params_from_jax([np.asarray(x) for x in jparams], device="cpu")
    v0 = float(params.face_distance[0] if name == "face_d0" else getattr(params, name))
    grad_fn, loss_fn, _ = gv.table_programs(gv.tilted_cfg(), params, rep, tau, TABLE_B, "cpu")
    for sd in TABLE_SEEDS:
        seed = torch.tensor(sd, dtype=torch.int64)
        (g,) = grad_fn(torch.tensor(v0), seed)
        want = float(jgrad(jnp.float32(v0), jnp.uint32(sd)))
        err = gv.grad_err(g.numpy(), want)
        assert want != 0 and err <= gv.GRAD_RTOL["soft" if tau else "free"], (sd, float(g), want)
        for v in (v0 + eps, v0 - eps):
            got = float(loss_fn(torch.tensor(v, dtype=torch.float32), seed))
            want = float(jloss(jnp.float32(v), jnp.uint32(sd)))
            assert abs(got - want) <= 2 * gv.IMG_RTOL * abs(want), (sd, v, got, want)
