"""DeepCache on the SD path of the port against the JAX package on the CPU,
f32, weights carried by load_flax_params: ddim_forward_deepcache_cond (with
and without classifier-free guidance) and x_space_guidance_scan_deepcache,
and the SD driver's finish and walk under edit_deepcache_interval /
guidance_deepcache_interval, where the port batches the directions that
the JAX driver vmaps.

Gates: interval 1 equals the port's plain ddim_forward /
x_space_guidance_scan to atol 1e-6; intervals 2 and 3 equal the JAX
package's at the same interval to atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import (  # noqa: F401
    flax_params,
    nchw,
    nhwc,
    one_torch_thread,
    sd_driver_pair,
)

from diffusion_pullback_tpu.models import configs as jcfg
from diffusion_pullback_tpu.models.unet2d import TapPoint as JTap
from diffusion_pullback_tpu.models.unet2d_condition import UNet2DCondition as JUNet
from diffusion_pullback_tpu.ops.schedule import DiffusionSchedule as JSchedule
from diffusion_pullback_tpu.ops.schedule import ddim_timestep_grid as jgrid
from diffusion_pullback_tpu.samplers.deepcache import (
    ddim_forward_deepcache_cond as jdeepcache,
)
from diffusion_pullback_tpu.samplers.guidance import (
    x_space_guidance_scan_deepcache as jscan_deepcache,
)
from diffusion_pullback_tpu_torch.models import (
    TapPoint,
    UNet2DCondition,
    load_flax_params,
    sd_tiny_unet,
)
from diffusion_pullback_tpu_torch.ops.schedule import DiffusionSchedule, ddim_timestep_grid
from diffusion_pullback_tpu_torch.samplers.ddim_loop import ddim_forward
from diffusion_pullback_tpu_torch.samplers.deepcache import ddim_forward_deepcache_cond
from diffusion_pullback_tpu_torch.samplers.guidance import (
    x_space_guidance_scan,
    x_space_guidance_scan_deepcache,
)

STEPS, START, GUIDANCE = 10, 2, 7.5


@pytest.fixture(scope="module")
def models():
    jm = JUNet(jcfg.sd_tiny_unet(8))
    rng = np.random.default_rng(41)
    x = rng.normal(size=(3, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(size=(1, 8, 16)).astype(np.float32)
    neg = rng.normal(size=(1, 8, 16)).astype(np.float32)
    params = flax_params(jm, jnp.asarray(x), jnp.float32(0.0), jnp.asarray(ctx))
    tm = load_flax_params(UNet2DCondition(sd_tiny_unet(8)), params).requires_grad_(False)
    return jm, params, tm, x, ctx, neg


def _cfg_kw(cfg_on, neg, cast):
    return dict(neg_context=cast(neg), guidance_scale=GUIDANCE) if cfg_on else {}


def _plain_eps(tm, ctx, neg, cfg_on):
    """ε on NCHW latents, with CFG as the SD driver's eps_with builds it."""
    c = torch.from_numpy(ctx)
    if not cfg_on:
        return lambda z, t: tm(z, t, c)

    def fn(z, t):
        b = z.shape[0]
        e_un, e_c = tm(torch.cat([z, z]), t, torch.cat([
            torch.from_numpy(neg).expand(b, -1, -1), c.expand(b, -1, -1)])).chunk(2)
        return e_un + GUIDANCE * (e_c - e_un)
    return fn


@pytest.mark.parametrize("cfg_on", [False, True], ids=["plain", "cfg"])
def test_deepcache_interval_1_is_the_plain_sampler(models, cfg_on):
    _, _, tm, x, ctx, neg = models
    sched, grid = DiffusionSchedule.scaled_linear(), ddim_timestep_grid(STEPS)
    with torch.no_grad():
        ref = ddim_forward(_plain_eps(tm, ctx, neg, cfg_on), nchw(x), sched, grid,
                           start_idx=START)
        out = ddim_forward_deepcache_cond(tm, nchw(x), torch.from_numpy(ctx), sched,
                                          grid, interval=1, start_idx=START,
                                          **_cfg_kw(cfg_on, neg, torch.from_numpy))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)


@pytest.mark.parametrize("cfg_on", [False, True], ids=["plain", "cfg"])
def test_deepcache_matches_jax_at_interval_3(models, cfg_on):
    jm, params, tm, x, ctx, neg = models
    ref = jax.jit(lambda p, xx: jdeepcache(
        jm, p, xx, jnp.asarray(ctx), JSchedule.scaled_linear(), jgrid(STEPS),
        interval=3, start_idx=START, **_cfg_kw(cfg_on, neg, jnp.asarray)))(
        params, jnp.asarray(x))
    with torch.no_grad():
        out = ddim_forward_deepcache_cond(
            tm, nchw(x), torch.from_numpy(ctx), DiffusionSchedule.scaled_linear(),
            ddim_timestep_grid(STEPS), interval=3, start_idx=START,
            **_cfg_kw(cfg_on, neg, torch.from_numpy))
        full = ddim_forward_deepcache_cond(
            tm, nchw(x), torch.from_numpy(ctx), DiffusionSchedule.scaled_linear(),
            ddim_timestep_grid(STEPS), interval=1, start_idx=START,
            **_cfg_kw(cfg_on, neg, torch.from_numpy))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=1e-4)
    assert np.abs(out.numpy() - full.numpy()).max() > 1e-4   # the cache was used


def _walk_fns(tm, ctx):
    tap, c = TapPoint("up", len(tm.up_blocks) - 2), torch.from_numpy(ctx)

    def full_fn(pair, t):
        h, state = tm.encode_with_state(pair, t, c, tap)
        return tm.decode_with_state(h, state, tap), h

    def reuse_fn(pair, t, h):
        return tm.decode_with_state(h, tm.shallow_encode(pair, t, c), tap)

    return full_fn, reuse_fn


@pytest.mark.parametrize("interval", [1, 2])
def test_walk_deepcache(models, interval):
    """The walk's [z; z+δv] pair with a cached deep path: interval 1 is the
    plain scan, interval 2 the JAX package's."""
    jm, params, tm, x, ctx, _ = models
    vk = np.random.default_rng(42).normal(size=x.shape).astype(np.float32)
    kw = dict(num_steps=4, edit_step=0.5, scale=0.3)
    t = np.float32(600.0)
    with torch.no_grad():
        out = x_space_guidance_scan_deepcache(*_walk_fns(tm, ctx), nchw(x),
                                              torch.tensor(t), nchw(vk),
                                              interval=interval, **kw)
        if interval == 1:
            ref = x_space_guidance_scan(lambda z, tt: tm(z, tt, torch.from_numpy(ctx)),
                                        nchw(x), torch.tensor(t), nchw(vk), **kw)
            np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)
            return
    jtap = JTap("up", 0)

    def jfull(pair, tt):
        h, state = jm.apply(params, pair, tt, jnp.asarray(ctx), jtap,
                            method=JUNet.encode_with_state)
        return jm.apply(params, h, state, jtap, method=JUNet.decode_with_state), h

    def jreuse(pair, tt, h):
        sh = jm.apply(params, pair, tt, jnp.asarray(ctx), method=JUNet.shallow_encode)
        return jm.apply(params, h, sh, jtap, method=JUNet.decode_with_state)

    ref = jax.jit(lambda z, v: jscan_deepcache(jfull, jreuse, z, t, v, interval=interval,
                                               **kw))(jnp.asarray(x), jnp.asarray(vk))
    np.testing.assert_allclose(out.permute(0, 1, 3, 4, 2).numpy(), np.asarray(ref),
                               atol=1e-4)


CFG = dict(dataset_name="noise", for_steps=STEPS, inv_steps=STEPS, edit_t=0.6,
           edit_prompt="a test prompt", neg_prompt="ugly", for_prompt="a photo",
           x_space_guidance_num_step=4, x_space_guidance_scale=0.5, vis_num=2)


@pytest.fixture(scope="module")
def drivers(tmp_path_factory):
    jdrv, tdrv = sd_driver_pair(tmp_path_factory.mktemp("dc"), CFG, size=8)
    rng = np.random.default_rng(43)
    zt = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    vks = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    return jdrv, tdrv, zt, vks


@pytest.mark.parametrize("guidance", [0.0, GUIDANCE], ids=["plain", "cfg"])
def test_driver_finish_under_deepcache(drivers, monkeypatch, guidance):
    """_finish_forward at edit_deepcache_interval 3 (with guidance_scale > 1
    the CFG rows inside the cache) against the JAX driver's; at interval 1
    the plain finish."""
    jdrv, tdrv, zt, vks = drivers
    sel = np.concatenate([zt, zt + 0.1 * vks[:1]]).astype(np.float32)
    for drv in (jdrv, tdrv):
        monkeypatch.setattr(drv.cfg, "guidance_scale", guidance)
        monkeypatch.setattr(drv.cfg, "edit_deepcache_interval", 3)
    ref = jdrv._finish_forward(jdrv.unet_params, jnp.asarray(sel), jdrv.for_prompt_emb,
                               jdrv.neg_prompt_emb)
    out = tdrv._finish_forward(torch.from_numpy(sel))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    monkeypatch.setattr(tdrv.cfg, "edit_deepcache_interval", 1)
    np.testing.assert_array_equal(tdrv._finish_forward(torch.from_numpy(sel)).numpy(),
                                  tdrv.DDIMforwardsteps(torch.from_numpy(sel),
                                                        tdrv.edit_t_idx).numpy())


def test_driver_walk_under_deepcache(drivers, monkeypatch):
    """_guidance_walk at guidance_deepcache_interval 2 over both directions
    in one batch against the JAX driver's walk of each direction."""
    jdrv, tdrv, zt, vks = drivers
    for drv in (jdrv, tdrv):
        monkeypatch.setattr(drv.cfg, "guidance_deepcache_interval", 2)
    t = jdrv.fwd_grid.timesteps[jdrv.edit_t_idx]
    out = tdrv._guidance_walk(torch.from_numpy(zt), torch.from_numpy(vks),
                              torch.tensor(float(t)))
    assert out.shape == (5, 2, 8, 8, 4)
    for d in range(2):
        ref = jdrv._guidance_walk(jdrv.unet_params, jdrv.edit_prompt_emb,
                                  jnp.asarray(zt), jnp.asarray(vks[d]), t)
        np.testing.assert_allclose(out[:, d].numpy(), np.asarray(ref)[:, 0], atol=1e-4)
