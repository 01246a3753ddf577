"""The port's ancestral DDPM sampler and uncond DeepCache against the JAX
package on the CPU, f32, weights carried by load_flax_params.

  - ``ddpm_step_learned_sigma`` on random inputs;
  - ``ddpm_forward`` on a tiny learned-σ UNetADM (adm_tiny(16)) over the
    respaced '10' grid (learned-range variance, the respaced β), with and
    without a classifier's ``cond_fn`` (adm_encoder_tiny(16), through
    condition_mean), and with the fixed-small variance on the ε half; the
    noise is JAX's own draws (k, sub = split(k); normal(sub, …)) handed in;
  - ``ddim_forward_deepcache`` on ddpm_tiny(16) at interval 1 (equal to
    ``ddim_forward``) and 3, against the JAX one.

Gates: one step within 1e-6 of max(1, max |ref|); a whole sampler run
within 1e-4 of max(1, max |ref|) (10 model passes at f32 whose roundoff
the clamp of x̂₀ and the division by √ᾱ grow)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import flax_params, nchw, nhwc, one_torch_thread  # noqa: F401

from diffusion_pullback_tpu import models as jmodels
from diffusion_pullback_tpu import samplers as jsamplers
from diffusion_pullback_tpu.models.unet2d import UNet2D as JUNet2D
from diffusion_pullback_tpu.ops import ddim as jddim
from diffusion_pullback_tpu.ops import schedule as jschedule
from diffusion_pullback_tpu.samplers import ddim_loop as jloop
from diffusion_pullback_tpu.samplers import deepcache as jdeepcache
from diffusion_pullback_tpu_torch import models as tmodels
from diffusion_pullback_tpu_torch.experiments._common import to_nchw, to_nhwc
from diffusion_pullback_tpu_torch.ops import ddim as tddim
from diffusion_pullback_tpu_torch.ops import schedule as tschedule
from diffusion_pullback_tpu_torch.samplers import ddim_loop as tloop
from diffusion_pullback_tpu_torch.samplers import deepcache as tdeepcache
from diffusion_pullback_tpu_torch.samplers import guidance as tguidance


def close(out, ref, tol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


def test_ddpm_step_learned_sigma_matches_jax():
    rng = np.random.default_rng(0)
    et, logvar, xt, noise = (rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
                             for _ in range(4))
    logvar = -np.abs(logvar) - 3.0
    at, bt = np.float32(0.42), np.float32(0.013)
    mine = tddim.ddpm_step_learned_sigma(*(torch.from_numpy(a) for a in (et, logvar, xt)),
                                         torch.tensor(at), torch.tensor(bt),
                                         torch.from_numpy(noise))
    ref = jddim.ddpm_step_learned_sigma(*(jnp.asarray(a) for a in (et, logvar, xt)),
                                        at, bt, jnp.asarray(noise))
    close(mine.prev_sample.numpy(), ref.prev_sample, 1e-6)
    close(mine.pred_original.numpy(), ref.pred_original, 1e-6)


@pytest.fixture(scope="module")
def adm():
    """(JAX ε fn, port ε fn, JAX cond_fn, port cond_fn) on adm_tiny(16) and
    adm_encoder_tiny(16) with shared weights, both NHWC at the sampler."""
    jnet = jmodels.UNetADM(jmodels.adm_tiny(16))
    npar = flax_params(jnet, jnp.zeros((1, 16, 16, 3)), jnp.float32(0.0), seed=31)
    tnet = tmodels.load_flax_params(tmodels.UNetADM(tmodels.adm_tiny(16)), npar)
    jclf = jmodels.EncoderUNetADM(jmodels.adm_encoder_tiny(16))
    cp = flax_params(jclf, jnp.zeros((1, 16, 16, 3)), jnp.float32(0.0), seed=32)
    tclf = tmodels.load_flax_params(tmodels.EncoderUNetADM(tmodels.adm_encoder_tiny(16)), cp)
    return (lambda x, t: jnet.apply(npar, x, t),
            lambda x, t: to_nhwc(tnet(to_nchw(x), t)),
            jsamplers.classifier_grad_fn(lambda z, t: jclf.apply(cp, z, t),
                                         jnp.asarray([3]), scale=4.0),
            tguidance.classifier_grad_fn(lambda z, t: tclf(to_nchw(z), t),
                                         torch.tensor([3]), scale=4.0))


def _jax_noises(key, steps, shape):
    """The draws of JAX's ddpm_forward: k, sub = split(k); normal(sub, …)."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return torch.from_numpy(np.stack(out))


@pytest.mark.parametrize("learn_sigma,guided", [(True, False), (True, True),
                                                (False, False)],
                         ids=["learned-range", "learned-range-guided", "fixed-small"])
def test_ddpm_forward_matches_jax_on_its_draws(adm, learn_sigma, guided):
    jeps, teps, jcond, tcond = adm
    if not learn_sigma:   # the ε half as a fixed-variance model
        jeps_, teps_ = jeps, teps
        jeps = lambda x, t: jeps_(x, t)[..., :3]
        teps = lambda x, t: teps_(x, t)[..., :3]
    steps = np.asarray(sorted(jschedule.space_timesteps(1000, "10")), np.float32)[::-1]
    assert sorted(tschedule.space_timesteps(1000, "10")) == sorted(steps.astype(int))
    x = np.random.default_rng(33).normal(size=(1, 16, 16, 3)).astype(np.float32)
    key = jax.random.key(34)
    ref = np.asarray(jax.jit(lambda z: jloop.ddpm_forward(
        jeps, z, jschedule.DiffusionSchedule.linear(), key, timesteps=jnp.asarray(steps),
        learn_sigma=learn_sigma, cond_fn=jcond if guided else None))(jnp.asarray(x)))
    with torch.no_grad():
        out = tloop.ddpm_forward(
            teps, torch.from_numpy(x), tschedule.DiffusionSchedule.linear(),
            timesteps=torch.from_numpy(steps.copy()), learn_sigma=learn_sigma,
            cond_fn=tcond if guided else None,
            noises=_jax_noises(key, len(steps), x.shape))
    assert out.shape == x.shape and torch.isfinite(out).all()
    close(out.numpy(), ref, 1e-4)
    if guided:   # the classifier moved the result
        with torch.no_grad():
            plain = tloop.ddpm_forward(
                teps, torch.from_numpy(x), tschedule.DiffusionSchedule.linear(),
                timesteps=torch.from_numpy(steps.copy()), learn_sigma=True,
                noises=_jax_noises(key, len(steps), x.shape))
        assert (out - plain).abs().max() > 1e-3


def test_ddpm_forward_draws_from_its_generator(adm):
    _, teps, _, _ = adm
    x = torch.zeros(1, 16, 16, 3)
    steps = torch.tensor([300.0, 200.0, 100.0, 0.0])
    run = lambda seed: tloop.ddpm_forward(
        teps, x, tschedule.DiffusionSchedule.linear(), torch.Generator().manual_seed(seed),
        timesteps=steps, learn_sigma=True)
    with torch.no_grad():
        a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and (a - c).abs().max() > 1e-3
    with pytest.raises(ValueError, match="3 noise tensors for 4 steps"):
        tloop.ddpm_forward(teps, x, tschedule.DiffusionSchedule.linear(), timesteps=steps,
                           noises=torch.zeros(3, *x.shape))


@pytest.fixture(scope="module")
def ddpm():
    jm = JUNet2D(jmodels.ddpm_tiny(16))
    params = flax_params(jm, jnp.zeros((1, 16, 16, 3)), jnp.float32(0.0), seed=35)
    tm = tmodels.load_flax_params(tmodels.UNet2D(tmodels.ddpm_tiny(16)), params)
    return jm, params, tm.requires_grad_(False)


@pytest.mark.parametrize("interval", [1, 3])
def test_uncond_deepcache_matches_jax(ddpm, interval):
    jm, params, tm = ddpm
    x = np.random.default_rng(36).normal(size=(2, 16, 16, 3)).astype(np.float32)
    jsched, tsched = (jschedule.DiffusionSchedule.linear(),
                      tschedule.DiffusionSchedule.linear())
    jgrid, tgrid = jschedule.ddim_timestep_grid(8), tschedule.ddim_timestep_grid(8)
    ref = np.asarray(jax.jit(lambda z: jdeepcache.ddim_forward_deepcache(
        jm, params, z, jsched, jgrid, interval=interval, start_idx=1))(jnp.asarray(x)))
    with torch.no_grad():
        out = tdeepcache.ddim_forward_deepcache(tm, nchw(x), tsched, tgrid,
                                                interval=interval, start_idx=1)
        full = tloop.ddim_forward(lambda z, t: to_nhwc(tm(to_nchw(z), t)),
                                  torch.from_numpy(x), tsched, tgrid, start_idx=1)
    close(nhwc(out), ref, 1e-4)
    if interval == 1:
        close(nhwc(out), full.numpy(), 1e-5)
    else:   # the cache changed the result, but not by much
        gap = np.abs(nhwc(out) - full.numpy()).max()
        assert 1e-6 < gap < np.abs(full.numpy()).max()


def test_uncond_deepcache_needs_two_up_blocks():
    import dataclasses

    cfg = tmodels.ddpm_tiny(16)
    one = dataclasses.replace(cfg, block_out_channels=cfg.block_out_channels[:1],
                              down_block_types=cfg.down_block_types[:1],
                              up_block_types=cfg.up_block_types[-1:])
    with pytest.raises(ValueError, match="at least 2 up blocks"):
        tdeepcache.ddim_forward_deepcache(
            tmodels.UNet2D(one), torch.zeros(1, 3, 16, 16),
            tschedule.DiffusionSchedule.linear(), tschedule.ddim_timestep_grid(4))
