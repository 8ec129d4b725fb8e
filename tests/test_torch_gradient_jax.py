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
