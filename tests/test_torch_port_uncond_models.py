"""The CelebA-HQ-256 path's modules in the port against the JAX package on
the CPU in float32: the linear and cosine schedules, performance boosting,
the stochastic DDIM scan on injected noise, and the DDPM UNet2D (ε, every
tap, decode from a tap, forward_dh) on weights moved by load_flax_params;
the full-width ddpm_celebahq_256 layout by names and shapes alone."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import flax_params, nchw, nhwc, one_torch_thread  # noqa: F401

from diffusion_pullback_tpu import models as jmodels
from diffusion_pullback_tpu.ops import DiffusionSchedule as JSchedule
from diffusion_pullback_tpu.ops import ddim_timestep_grid as jgrid
from diffusion_pullback_tpu.samplers import ddim_loop as jloop
from diffusion_pullback_tpu_torch import models as tmodels
from diffusion_pullback_tpu_torch.models import convert
from diffusion_pullback_tpu_torch.ops.schedule import (
    DiffusionSchedule, beta, ddim_timestep_grid)
from diffusion_pullback_tpu_torch.samplers import ddim_loop as tloop

CONFIGS = {"tiny": {}, "tiny_asymmetric": {"asymmetric_downsample": True}}
TAPS = [("down", 0, None), ("down", 1, None), ("mid", 0, None), ("up", 0, None),
        ("up", 1, None), ("down", 0, ("res", 0)), ("down", 1, ("res", 0)),
        ("down", 1, ("attn", 0))]
T = 412.7


@pytest.mark.parametrize("name", ["linear", "cosine", "scaled_linear"])
def test_schedule_tables_equal_jax(name):
    mine, theirs = DiffusionSchedule.from_name(name), JSchedule.from_name(name)
    np.testing.assert_array_equal(mine.betas.numpy(), np.asarray(theirs.betas))
    np.testing.assert_array_equal(mine.alphas_cumprod.numpy(),
                                  np.asarray(theirs.alphas_cumprod))
    np.testing.assert_array_equal(beta(mine, torch.tensor([0.5, 998.9, 2000.0])).numpy(),
                                  mine.betas.numpy()[[0, 998, 999]])


@pytest.mark.parametrize("num_steps", [10, 20, 100])
def test_performance_boost_etas_equal_jax(num_steps):
    grid = ddim_timestep_grid(num_steps)
    below = grid.timesteps.numpy() < 200.0
    for idx in (None, int(below.argmax()), 0, grid.num_steps - 1):
        np.testing.assert_array_equal(
            tloop.performance_boost_etas(grid.num_steps, idx),
            jloop.performance_boost_etas(grid.num_steps, idx))
    # on a 10-step grid the 0.2·T boost index is the last step: no boost
    assert tloop.performance_boost_etas(9, 8).sum() == 0


def _jax_noise(key, n, shape):
    """The draws of JAX ddim_scan's stochastic steps: one split a step."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(torch.tensor(np.asarray(jax.random.normal(sub, shape))))
    return out


def test_ddim_scan_with_eta_one_on_injected_noise():
    shape = (2, 4, 4, 3)
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    w = np.float32(0.3)
    grid = ddim_timestep_grid(8)
    etas = np.array([0, 0, 1, 1, 0, 1, 1], np.float32)
    key = jax.random.key(7)
    jx, (jtraj, jeps) = jloop.ddim_scan(
        lambda z, t: jnp.tanh(z) * w + t / 1000.0, jnp.asarray(x), JSchedule.linear(),
        jgrid(8).timesteps, jgrid(8).timesteps_next, etas=jnp.asarray(etas), key=key,
        collect_trajectory=True, collect_eps=True)
    tx, (ttraj, teps) = tloop.ddim_scan(
        lambda z, t: torch.tanh(z) * w + t / 1000.0, torch.from_numpy(x),
        DiffusionSchedule.linear(), grid.timesteps, grid.timesteps_next, etas=etas,
        noise=_jax_noise(key, 7, shape), collect_trajectory=True, collect_eps=True)
    # 1e-6 of the trajectory's scale (|x| reaches ~200 here: the toy ε is
    # no denoiser, so x̂₀ = (x − √(1−ᾱ)ε)/√ᾱ grows at small ᾱ)
    tol = 1e-6 * np.abs(np.asarray(jtraj)).max()
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=tol)
    np.testing.assert_allclose(ttraj.numpy(), np.asarray(jtraj), rtol=0, atol=tol)
    np.testing.assert_allclose(teps.numpy(), np.asarray(jeps), rtol=0, atol=1e-6)


def _models(kind):
    jcfg = dataclasses.replace(jmodels.ddpm_tiny(32), **CONFIGS[kind])
    jm = jmodels.UNet2D(jcfg)
    params = flax_params(jm, jnp.zeros((1, 32, 32, 3)), jnp.float32(0.0), seed=3)
    tm = tmodels.load_flax_params(
        tmodels.UNet2D(dataclasses.replace(tmodels.ddpm_tiny(32), **CONFIGS[kind])),
        params)
    x = np.random.default_rng(4).normal(size=(2, 32, 32, 3)).astype(np.float32)
    return jm, params, tm.eval(), x


@pytest.fixture(scope="module", params=list(CONFIGS))
def models(request):
    return _models(request.param)


def _close(mine, theirs):
    theirs = np.asarray(theirs)
    np.testing.assert_allclose(mine, theirs, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(theirs).max()))


def test_eps_matches_jax(models):
    jm, params, tm, x = models
    with torch.no_grad():
        _close(nhwc(tm(nchw(x), T)), jm.apply(params, jnp.asarray(x), T))


@pytest.mark.parametrize("op,block,inner", TAPS)
def test_tap_matches_jax(models, op, block, inner):
    jm, params, tm, x = models
    tap = tmodels.TapPoint(op, block, inner)
    with torch.no_grad():
        mine = nhwc(tm.encode(nchw(x), T, tap))
    _close(mine, jm.apply(params, jnp.asarray(x), T, jmodels.TapPoint(op, block, inner),
                          method=jmodels.UNet2D.encode))


@pytest.mark.parametrize("op,block", [("down", 0), ("down", 1), ("mid", 0),
                                      ("up", 0), ("up", 1)])
def test_decode_of_encode_is_eps_and_forward_dh_matches_jax(models, op, block):
    jm, params, tm, x = models
    tap = tmodels.TapPoint(op, block)
    x1 = x[:1]
    with torch.no_grad():
        eps = tm(nchw(x1), T)
        h, state = tm.encode_with_state(nchw(x1), T, tap)
        np.testing.assert_array_equal(tm.decode_with_state(h, state, tap).numpy(),
                                      eps.numpy())
        # a probe batch of 2 perturbations against the batch-1 state (batch
        # 2 on the JAX side, the shapes its eager ops have compiled for)
        dh = torch.from_numpy(np.random.default_rng(5).normal(
            size=(2, *h.shape[1:])).astype(np.float32)) * 0.1
        mine = nhwc(tm.forward_dh(nchw(x1), T, dh, tap))
    theirs = jm.apply(params, jnp.asarray(np.repeat(x1, 2, 0)), T,
                      jnp.asarray(nhwc(dh)), jmodels.TapPoint(op, block),
                      method=jmodels.UNet2D.forward_dh)
    _close(mine, theirs)


def test_shallow_encode_matches_jax(models):
    jm, params, tm, x = models
    with torch.no_grad():
        mine = tm.shallow_encode(nchw(x), T)
    theirs = jm.apply(params, jnp.asarray(x), T, method=jmodels.UNet2D.shallow_encode)
    _close(mine.emb.numpy(), theirs.emb)
    assert len(mine.skips) == len(theirs.skips)
    for a, b in zip(mine.skips, theirs.skips):
        _close(nhwc(a), b)


def test_celebahq_256_layout_matches_jax():
    """Names and shapes of the Flax tree, converted, against the port's
    state_dict, from jax.eval_shape and a meta-device module."""
    jm = jmodels.UNet2D(jmodels.ddpm_celebahq_256())
    tree = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, 256, 256, 3)),
                          jnp.float32(0.0))["params"]
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    theirs = {}
    for path, leaf in flat:
        keys = [p.key for p in path]
        shape = leaf.shape
        if keys[-1] == "kernel":
            shape = (shape[3], shape[2], *shape[:2]) if len(shape) == 4 else shape[::-1]
        theirs[convert._torch_name(keys[:-1], keys[-1], clip=False)] = tuple(shape)
    with torch.device("meta"):
        tm = tmodels.model_for_name("CelebA_HQ_HF")
    mine = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert mine == theirs
    assert sum(np.prod(s) for s in mine.values()) == 113_673_219


def test_model_for_name_routes_hf_and_refuses_adm():
    with torch.device("meta"):
        m = tmodels.model_for_name("LSUN_church_HF", dtype="bfloat16")
    assert m.config == tmodels.ddpm_celebahq_256().__class__(dtype="bfloat16")
    assert m.conv_in.weight.dtype == torch.bfloat16
    with torch.device("meta"):
        adm = tmodels.model_for_name("ImageNet256Uncond", dtype="bfloat16",
                                     attn_impl="flash")
    assert isinstance(adm, tmodels.UNetADM)
    assert adm.config == tmodels.adm_imagenet256_uncond().__class__(
        dtype="bfloat16", attn_impl="flash")
    assert adm.out[2].weight.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="model_name choice"):
        tmodels.model_for_name("WAT")
