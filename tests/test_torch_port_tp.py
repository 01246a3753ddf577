"""Megatron tensor parallelism in the port (parallel/tp.py: explicit local
slices, copy_to_region before a column-parallel layer, all_reduce after a
row-parallel one) against the JAX package's GSPMD layout
(diffusion_pullback_tpu/parallel/tp.py) on the 8-device CPU mesh of
tests/conftest.py, on the same weights (load_flax_params).

One launch of 4 gloo ranks (tests/torch_port_dist.py): sd_tiny_unet(8)'s ε
on a 2×2 dp×tp mesh against the JAX dp×tp forward, with the same count of
sharded leaves as JAX's tp_sharded_leaf_count; a GEGLU feed-forward at
tp=2 (each half of its fused proj sliced apart) in forward, jvp and vjp;
and the tp=2 uncond mid-tap pullback (JAX test_tp_mesh_matches_single_device)
of a DDPM U-Net with two heads, whose attention shards."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from torch_port_common import flax_params, one_torch_thread  # noqa: F401
from torch_port_dist import launch, tp_body

from diffusion_pullback_tpu import models as jmodels
from diffusion_pullback_tpu.geometry import local_pullback as jpullback
from diffusion_pullback_tpu.geometry.pullback import _orthonormal_probes
from diffusion_pullback_tpu.models.transformer2d import FeedForward as JFeedForward
from diffusion_pullback_tpu.parallel import make_mesh as jmesh
from diffusion_pullback_tpu.parallel import tp_param_specs as jspecs
from diffusion_pullback_tpu.parallel import tp_shard_params as jshard
from diffusion_pullback_tpu.parallel import tp_sharded_leaf_count as jcount
from diffusion_pullback_tpu_torch import models as tmodels

T = 321.0


def _state(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(size=(4, 7, 16)).astype(np.float32)
    jsd = jmodels.UNet2DCondition(jmodels.sd_tiny_unet(8))
    sd_params = flax_params(jsd, jnp.asarray(x[:1]), jnp.float32(T), jnp.asarray(ctx[:1]))
    ff_params = {"params": {
        "net_0": {"proj": {"kernel": rng.normal(size=(8, 64)).astype(np.float32) / 3,
                           "bias": rng.normal(size=(64,)).astype(np.float32) / 3}},
        "net_2": {"kernel": rng.normal(size=(32, 8)).astype(np.float32) / 6,
                  "bias": rng.normal(size=(8,)).astype(np.float32) / 3}}}
    ff = tmodels.transformer2d.FeedForward(8)
    g, o = ff_params["params"]["net_0"]["proj"], ff_params["params"]["net_2"]
    ff.load_state_dict({"net.0.proj.weight": torch.from_numpy(g["kernel"].T.copy()),
                        "net.0.proj.bias": torch.from_numpy(g["bias"]),
                        "net.2.weight": torch.from_numpy(o["kernel"].T.copy()),
                        "net.2.bias": torch.from_numpy(o["bias"])})
    ddpm_cfg = dataclasses.replace(jmodels.ddpm_tiny(16), attention_head_dim=8)
    ddpm_x = rng.normal(size=(1, 16, 16, 3)).astype(np.float32)
    jddpm = jmodels.UNet2D(ddpm_cfg)
    ddpm_params = flax_params(jddpm, jnp.asarray(ddpm_x), jnp.float32(T))
    tcfg = dataclasses.replace(tmodels.ddpm_tiny(16), attention_head_dim=8)
    data = dict(
        t=T, x=x, ctx=ctx,
        sd_unet=_state(tmodels.load_flax_params(
            tmodels.UNet2DCondition(tmodels.sd_tiny_unet(8)), sd_params)),
        ff=_state(ff), ff_x=rng.normal(size=(2, 5, 8)).astype(np.float32),
        ff_t=rng.normal(size=(2, 5, 8)).astype(np.float32),
        ddpm_cfg=tcfg, ddpm=_state(tmodels.load_flax_params(tmodels.UNet2D(tcfg),
                                                            ddpm_params)),
        ddpm_x=ddpm_x,
        ddpm_v0=np.asarray(_orthonormal_probes(jax.random.key(3), ddpm_x.size, 4)))
    ranks = launch(tp_body, 4, tmp_path_factory.mktemp("tp"), data)
    jax_side = dict(jsd=jsd, sd_params=sd_params, ff_params=ff_params, jddpm=jddpm,
                    ddpm_params=ddpm_params)
    return ranks, data, jax_side


def test_sharded_leaf_count_equals_jax(setup):
    ranks, _, j = setup
    count = jcount(jspecs(j["sd_params"], jmesh(("tp",), shape={"tp": 2})))
    assert [r["count"] for r in ranks] == [count] * 4 == [56] * 4
    sharded = ranks[0]["sharded"]
    for leaf in ("attn1.to_q.weight", "attn2.to_v.weight", "attn1.to_out.0.weight",
                 "ff.net.0.proj.weight", "ff.net.0.proj.bias", "ff.net.2.weight",
                 "proj_in.weight", "proj_in.bias", "proj_out.weight"):
        assert any(k.endswith(leaf) for k in sharded), leaf
    assert not any(k.endswith(("to_out.0.bias", "net.2.bias", "proj_out.bias", "norm1.weight"))
                   for k in sharded)
    # every sharded leaf belongs to a layer named in the Megatron layout
    from diffusion_pullback_tpu_torch.parallel.tp import COLUMN_PARALLEL, ROW_PARALLEL

    owners = {k.rsplit(".", 1)[0] for k in sharded}
    assert all(o.endswith(tuple("." + n for n in COLUMN_PARALLEL | ROW_PARALLEL))
               for o in owners), owners


def test_dp_tp_forward_matches_jax(setup):
    ranks, data, j = setup
    mesh = jmesh(("dp", "tp"), shape={"dp": 2, "tp": 2})
    params = jshard(j["sd_params"], mesh)
    xs, cs = (jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("dp")))
              for a in (data["x"], data["ctx"]))
    with mesh:
        ref = np.asarray(jax.jit(j["jsd"].apply)(params, xs, jnp.float32(T), cs))
    for r in ranks:
        np.testing.assert_allclose(r["sd_eps"], ref, atol=2e-5, rtol=1e-5)


def test_geglu_at_tp2_matches_jax(setup):
    ranks, data, j = setup
    jff = JFeedForward(8)
    mesh = jmesh(("tp",), shape={"tp": 2})
    params = jshard(j["ff_params"], mesh)
    y, ty = jnp.asarray(data["ff_x"]), jnp.asarray(data["ff_t"])
    f = lambda z: jff.apply(params, z)
    with mesh:
        out, tang = jax.jvp(f, (y,), (ty,))
        cot = jax.vjp(f, y)[1](ty)[0]
    for r in ranks:
        np.testing.assert_allclose(r["ff"], np.asarray(out), atol=1e-5)
        np.testing.assert_allclose(r["ff_jvp"], np.asarray(tang), atol=1e-5)
        np.testing.assert_allclose(r["ff_vjp"], np.asarray(cot), atol=1e-5)


def test_tp_uncond_pullback_matches_jax(setup):
    """The two-head DDPM U-Net's attention runs one head per rank; its
    mid-tap basis equals the JAX pullback's (which JAX's own TP mesh test
    holds equal to its tp mesh run)."""
    ranks, data, j = setup
    tap = jmodels.TapPoint("mid", 0)
    ref = jpullback(lambda z: j["jddpm"].apply(j["ddpm_params"], z, jnp.float32(T), tap,
                                               method=jmodels.UNet2D.encode),
                    jnp.asarray(data["ddpm_x"]), jax.random.key(0), pca_rank=4,
                    min_iter=3, max_iter=3, atol=0.0, v_init=jnp.asarray(data["ddpm_v0"]))
    for r in ranks:
        assert 1 in r["ddpm_heads"]  # 2 heads over tp=2: one local head
        res = r["ddpm_pullback"]
        np.testing.assert_allclose(res.s, np.asarray(ref.s), rtol=1e-4)
        np.testing.assert_allclose(res.vT, np.asarray(ref.vT), atol=1e-4)
