"""Port modules against the JAX package at tiny widths, f32, atol 1e-5:
schedule, DDIM step, ResnetBlock, Transformer2D and the CLIP text tower.
Weights are seeded numpy values (torch_port_common.flax_params: every bias
and norm scale nonzero) moved with load_flax_params; inputs are made with
numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import flax_params, nchw, one_torch_thread  # noqa: F401

from diffusion_pullback_tpu.models import clip_text as jclip
from diffusion_pullback_tpu.models.configs import clip_text_tiny as jclip_tiny
from diffusion_pullback_tpu.models.layers import ResnetBlock as JResnet
from diffusion_pullback_tpu.models.transformer2d import Transformer2D as JT2D
from diffusion_pullback_tpu.ops import ddim as jddim
from diffusion_pullback_tpu.ops import schedule as jsched
from diffusion_pullback_tpu_torch.models import clip_text as tclip
from diffusion_pullback_tpu_torch.models.configs import clip_text_tiny
from diffusion_pullback_tpu_torch.models.convert import load_flax_params
from diffusion_pullback_tpu_torch.models.layers import ResnetBlock
from diffusion_pullback_tpu_torch.models.transformer2d import Transformer2D
from diffusion_pullback_tpu_torch.ops import ddim, schedule

ATOL = 1e-5


def test_schedule_tables_and_grids_match():
    js, ts = jsched.DiffusionSchedule.scaled_linear(), schedule.DiffusionSchedule.scaled_linear()
    np.testing.assert_array_equal(ts.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod))
    np.testing.assert_array_equal(ts.betas.numpy(), np.asarray(js.betas))
    for inversion in (False, True):
        jg = jsched.ddim_timestep_grid(10, inversion=inversion)
        tg = schedule.ddim_timestep_grid(10, inversion=inversion)
        np.testing.assert_array_equal(tg.timesteps.numpy(), np.asarray(jg.timesteps))
        np.testing.assert_array_equal(tg.timesteps_next.numpy(), np.asarray(jg.timesteps_next))
        np.testing.assert_array_equal(
            schedule.alpha_bar(ts, tg.timesteps).numpy(),
            np.asarray(jsched.alpha_bar(js, jg.timesteps)))


@pytest.mark.parametrize("with_noise", [False, True])
def test_ddim_step_matches(with_noise):
    rng = np.random.default_rng(0)
    et, xt, noise = (rng.normal(size=(2, 8, 8, 4)).astype(np.float32) for _ in range(3))
    at, an = np.float32(0.3), np.float32(0.6)
    kw = dict(eta=0.5, noise=noise) if with_noise else {}
    ref = jddim.ddim_step(*map(jnp.asarray, (et, xt, at, an)),
                          **{k: jnp.asarray(v) for k, v in kw.items()})
    tkw = dict(eta=0.5, noise=torch.from_numpy(noise)) if with_noise else {}
    out = ddim.ddim_step(*map(torch.as_tensor, (et, xt, at, an)), **tkw)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL)


def test_resnet_block_matches():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 8, 8)).astype(np.float32)
    temb = rng.normal(size=(2, 32)).astype(np.float32)
    jm = JResnet(16, norm_num_groups=4, eps=1e-5)
    params = flax_params(jm, jnp.asarray(x), jnp.asarray(temb))
    ref = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(temb)))
    tm = load_flax_params(ResnetBlock(8, 16, 32, 4, eps=1e-5), params)
    out = tm(nchw(x), torch.from_numpy(temb)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("linear", [True, False])
def test_transformer2d_matches(linear):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 8, 8)).astype(np.float32)
    ctx = rng.normal(size=(2, 7, 16)).astype(np.float32)
    jm = JT2D(heads=2, head_dim=4, use_linear_projection=linear, norm_num_groups=4)
    params = flax_params(jm, jnp.asarray(x), jnp.asarray(ctx))
    ref = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(ctx)))
    tm = load_flax_params(
        Transformer2D(8, 2, 4, 16, use_linear_projection=linear, norm_num_groups=4),
        params)
    out = tm(nchw(x), torch.from_numpy(ctx)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_clip_text_tower_matches():
    prompts = ["", "a photo of a cat", "an oil painting of a smiling face"]
    ids_j = jclip.HashTokenizer(128, 8)(prompts)
    ids_t = tclip.HashTokenizer(128, 8)(prompts)
    np.testing.assert_array_equal(ids_t, ids_j)
    jm = jclip.CLIPTextModel(jclip_tiny())
    params = flax_params(jm, jnp.asarray(ids_j))
    ref = np.asarray(jm.apply(params, jnp.asarray(ids_j)))
    tm = load_flax_params(tclip.CLIPTextModel(clip_text_tiny()), params)
    out = tm(torch.from_numpy(ids_t).long()).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_load_flax_params_rejects_mismatch():
    x = jnp.zeros((1, 8, 8, 8))
    params = flax_params(JResnet(16, norm_num_groups=4), x, None)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_flax_params(ResnetBlock(8, 8, None, 4), params)
    with pytest.raises(RuntimeError, match="Missing key"):
        load_flax_params(ResnetBlock(8, 16, 32, 4), params)
