"""The fused-pair pullback of the port on the CPU: local_pullback(fn,
fn_vjp=…) on the tiny SD U-Net encoder at 32×32 latents, whose first block
self-attends over 1024 tokens and so reaches the pair ('flash_jvp' for the
tangent half, 'flash' for the cotangent half), against the JAX package's
pair-driven local_pullback with the same v_init and a fixed number of
iterations (σ rtol 1e-3, |cos| ≥ 0.99 per direction); and the SD editing
experiment's compute_local_basis with pullback_attn_impl='flash' running
the kernels' plain versions."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import flax_params, one_torch_thread  # noqa: F401

from diffusion_pullback_tpu.geometry import local_pullback as jlocal_pullback
from diffusion_pullback_tpu.models import configs as jcfg
from diffusion_pullback_tpu.models.unet2d import TapPoint as JTap
from diffusion_pullback_tpu.models.unet2d_condition import UNet2DCondition as JUNet
from diffusion_pullback_tpu_torch import experiments as texp
from diffusion_pullback_tpu_torch import models as tmodels
from diffusion_pullback_tpu_torch.geometry import local_pullback
from diffusion_pullback_tpu_torch.models import TapPoint
from diffusion_pullback_tpu_torch.models.layers import attn_impl_as
from diffusion_pullback_tpu_torch.ops import flash_attention as tfa
from diffusion_pullback_tpu_torch.ops.schedule import DiffusionSchedule
from diffusion_pullback_tpu_torch.utils.datasets import NoiseDataset
from diffusion_pullback_tpu_torch.utils.logging import JSONLLogger

PLAIN = ("flash_forward_plain", "flash_forward_lse_plain", "flash_tangent_plain",
         "flash_dq_plain", "flash_dkv_plain")


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts of the kernels' plain versions run (the CPU side of K1–K5)."""
    calls = dict.fromkeys(PLAIN, 0)
    for name in PLAIN:
        real = getattr(tfa, name)

        def spy(*a, _n=name, _f=real, **kw):
            calls[_n] += 1
            return _f(*a, **kw)

        monkeypatch.setattr(tfa, name, spy)
    return calls


def _agree(res, ref_s, ref_vT):
    np.testing.assert_allclose(res.s.numpy(), np.asarray(ref_s), rtol=1e-3)
    cos = np.abs(np.sum(res.vT.numpy() * np.asarray(ref_vT), axis=1))
    assert cos.min() >= 0.99, cos


def test_pair_pullback_matches_jax_on_unet_encoder(plain_calls):
    jcfg32 = dataclasses.replace(jcfg.sd_tiny_unet(32), attn_impl="flash")
    rng = np.random.default_rng(5)
    z = rng.normal(size=(1, 32, 32, 4)).astype(np.float32)
    ctx = rng.normal(size=(1, 8, 16)).astype(np.float32)
    t = np.float32(600.0)
    params = flax_params(JUNet(jcfg32), jnp.asarray(z), jnp.float32(0.0),
                         jnp.asarray(ctx))
    tm = tmodels.load_flax_params(
        tmodels.UNet2DCondition(tmodels.sd_tiny_unet(32)), params)
    tm.requires_grad_(False)

    rank, dim_x = 3, z.size
    v_init = np.linalg.qr(rng.normal(size=(dim_x, rank)))[0].T.astype(np.float32)
    kw = dict(pca_rank=rank, min_iter=2, max_iter=2, atol=0.0)

    # the JAX pair: custom_jvp kernels for the tangents, custom_vjp for the
    # cotangents (Pallas in interpret mode on the CPU)
    def jenc(impl):
        m = JUNet(dataclasses.replace(jcfg32, attn_impl=impl))
        return lambda zz: m.apply(params, zz, t, jnp.asarray(ctx), JTap("mid"),
                                  method=JUNet.encode)

    ref = jax.jit(lambda zz, v0: jlocal_pullback(
        jenc("flash_jvp"), zz, jax.random.key(0), v_init=v0,
        fn_vjp=jenc("flash"), **kw))(jnp.asarray(z), jnp.asarray(v_init))

    def tenc(impl):
        def enc(zz):  # NHWC on both sides, as EditStableDiffusion flattens
            with attn_impl_as(tm, impl):
                h = tm.encode(zz.permute(0, 3, 1, 2), torch.tensor(t),
                              torch.from_numpy(ctx), TapPoint("mid"))
            return h.permute(0, 2, 3, 1)
        return enc

    res = local_pullback(tenc("flash_jvp"), torch.from_numpy(z),
                         v_init=torch.from_numpy(v_init),
                         fn_vjp=tenc("flash"), **kw)
    assert res.iterations == int(ref.iterations) == 2
    _agree(res, ref.s, ref.vT)
    # one 1024-token self-attention in the encoder: K2 once per tangent pass
    # (2 iterations + the final u) and once for the vjp; K3 once per tangent
    # pass; K4 and K5 once per iteration; K1 never
    assert plain_calls == {
        "flash_forward_plain": 0, "flash_forward_lse_plain": 4,
        "flash_tangent_plain": 3, "flash_dq_plain": 2, "flash_dkv_plain": 2}


def _port_experiment(tmp_path, pullback_attn_impl, unet_attn="xla"):
    unet = tmodels.random_init_(tmodels.UNet2DCondition(dataclasses.replace(
        tmodels.sd_tiny_unet(32), attn_impl=unet_attn)), 0)
    vae = tmodels.random_init_(tmodels.AutoencoderKL(tmodels.vae_tiny(64)), 1)
    text = tmodels.random_init_(tmodels.CLIPTextModel(dataclasses.replace(
        tmodels.clip_text_tiny(), hidden_size=16)), 2)
    cfg = texp.SDExperimentConfig(
        dataset_name="noise", edit_prompt="a test prompt", pca_rank=2,
        pullback_min_iter=2, pullback_max_iter=2, pullback_atol=0.0,
        pullback_attn_impl=pullback_attn_impl,
        result_folder=str(tmp_path / "runs"), basis_folder=str(tmp_path / "in"))
    return texp.EditStableDiffusion(
        unet, vae, text, DiffusionSchedule.scaled_linear(), NoiseDataset(64, n=1),
        cfg, logger=JSONLLogger(str(tmp_path / "log.jsonl"), echo=False),
        device="cpu")


def test_experiment_flash_pullback_runs_the_pair(tmp_path, plain_calls):
    """compute_local_basis with pullback_attn_impl='flash' runs the pair's
    plain versions, logs the encoder as 'flashpair', and agrees with the
    math path's basis from the same seed."""
    drv = _port_experiment(tmp_path, "flash")
    zt = torch.from_numpy(np.random.default_rng(6).normal(
        size=(1, 32, 32, 4)).astype(np.float32))
    res = drv.compute_local_basis(zt, torch.tensor(500.0), TapPoint("mid"), 2)
    passes = res.iterations + 1  # tangent passes: each iteration, final u
    assert plain_calls == {
        "flash_forward_plain": 0, "flash_forward_lse_plain": passes + 1,
        "flash_tangent_plain": passes, "flash_dq_plain": res.iterations,
        "flash_dkv_plain": res.iterations}
    with open(drv.log.path) as f:
        events = [json.loads(line) for line in f]
    assert [e["encoder"] for e in events if e["event"] == "sd_local_pullback"
            ] == ["flashpair"]

    drv.cfg.pullback_attn_impl = "xla"
    ref = drv.compute_local_basis(zt, torch.tensor(500.0), TapPoint("mid"), 2)
    assert plain_calls["flash_tangent_plain"] == passes  # the math path ran
    _agree(res, ref.s, ref.vT)


@pytest.mark.parametrize("pullback,unet_attn,tag", [
    ("flash", "xla", "flashpair"), ("", "flash", "flashpair"),
    ("xla", "flash", "xla"), ("", "xla", "xla")])
def test_pullback_tap_encoders_select_the_pair(tmp_path, pullback, unet_attn, tag):
    """'flash', or '' with a U-Net that runs 'flash', maps to the pair (a
    second encoder for the vjp); anything else to one encoder."""
    drv = _port_experiment(tmp_path, pullback, unet_attn)
    enc, enc_vjp, got = drv._pullback_tap_encoders(torch.tensor(500.0),
                                                   TapPoint("mid"))
    assert got == tag and (enc_vjp is not None) == (tag == "flashpair")
