"""SD 1.5 in the port against the JAX package on the CPU, f32, weights
carried by load_flax_params.

A tiny SD 1.5-shaped U-Net (torch_port_common.sd15_tiny_arch: 1×1-conv
projections, per-block head counts and dims, a quick-GELU tower read at its
final LayerNorm) at 32² latents, so its first block self-attends over 1024
tokens: on the JAX side through the Pallas kernels in interpret mode, on
the port's through the kernels' plain versions. Both drivers are built
from the modules directly, as a user of either package builds SD 1.5 (no
CLI of either builds it). ε, the tapped h and the mid-tap pullback on the
fused pair are held to the JAX package's, and the port's driver runs the
encoder-pullback edit end to end on these modules.

Then the full-width layouts, built on the meta device, against the JAX
package's own torch export of its jax.eval_shape tree: SD 1.5's U-Net and
CLIP ViT-L tower, SD 2.1-base's U-Net, VAE and OpenCLIP ViT-H tower, and
ImageNet128Cond's UNetADM.

Gates: ε and h within 1e-5 of max(1, max |ref|); σ rtol 1e-3 and
|cos| ≥ 0.99 per direction."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import (  # noqa: F401
    jax_layout,
    nhwc,
    one_torch_thread,
    plain_shapes,
    port_layout,
    sd15_tiny_arch,
    sd_driver_pair,
)

from diffusion_pullback_tpu.geometry import local_pullback as jlocal_pullback
from diffusion_pullback_tpu.models import adm as jadm
from diffusion_pullback_tpu.models import configs as jcfg
from diffusion_pullback_tpu.models.clip_text import CLIPTextModel as JCLIP
from diffusion_pullback_tpu.models.unet2d import TapPoint as JTap
from diffusion_pullback_tpu.models.unet2d_condition import UNet2DCondition as JUNet
from diffusion_pullback_tpu.models.vae import AutoencoderKL as JVAE
from diffusion_pullback_tpu_torch import models as tmodels
from diffusion_pullback_tpu_torch.geometry import local_pullback
from diffusion_pullback_tpu_torch.models import TapPoint
from diffusion_pullback_tpu_torch.models.layers import attn_impl_as

RANK = 2
CFG = dict(dataset_name="noise", for_steps=4, inv_steps=4, edit_t=0.5,
           edit_prompt="a test prompt", pca_rank=RANK, pullback_min_iter=2,
           pullback_max_iter=2, pullback_atol=0.0, pullback_attn_impl="flash",
           x_space_guidance_num_step=2)


@pytest.fixture(scope="module")
def drivers(tmp_path_factory):
    """(JAX driver, port driver, z_t, t, v_init) on shared weights."""
    jdrv, tdrv = sd_driver_pair(tmp_path_factory.mktemp("sd15"), CFG, arch=sd15_tiny_arch)
    rng = np.random.default_rng(15)
    zt = rng.normal(size=(1, 32, 32, 4)).astype(np.float32)
    v_init = np.linalg.qr(rng.normal(size=(zt.size, RANK)))[0].T.astype(np.float32)
    t = jdrv.fwd_grid.timesteps[jdrv.edit_t_idx]
    return jdrv, tdrv, zt, t, v_init


def _close(mine, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(mine, ref, atol=1e-5 * max(1.0, np.abs(ref).max()))


def test_sd15_tiny_is_sd15_shaped(drivers):
    _, tdrv, *_ = drivers
    cfg = tdrv.unet.config
    assert not cfg.use_linear_projection and cfg.attention_head_dim == (8, 12)
    assert isinstance(tdrv.unet.down_blocks[0].attentions[0].proj_in, torch.nn.Conv2d)
    assert tdrv.text_model.config.hidden_act == "quick_gelu"


def test_eps_through_the_kernels_matches_jax(drivers, plain_shapes):
    """ε with attn_impl='flash' on both sides (the JAX U-Net at 1024 tokens
    on the Pallas kernels in interpret mode, the port's on K1's plain
    version: three calls at 1024 tokens, 2 heads each: down block 0, and
    up block 1 with its two layers), the edit prompt's
    context, at batch 2."""
    jdrv, tdrv, zt, t, _ = drivers
    z = np.concatenate([zt, 0.5 * zt])
    ref = jax.jit(jdrv._unet_variant("flash").apply)(
        jdrv.unet_params, jnp.asarray(z), jnp.float32(t), jdrv.edit_prompt_emb)
    with torch.no_grad(), attn_impl_as(tdrv.unet, "flash"):
        eps = tdrv.unet(torch.from_numpy(z).permute(0, 3, 1, 2), float(t),
                        tdrv.edit_prompt_emb)
    _close(nhwc(eps), ref)
    assert plain_shapes["flash_forward_plain"] == [(4, 4, 1024)] * 3


def test_text_tower_is_the_final_layer_norm(drivers):
    """SD 1.5's context is the tower's last hidden state after the final
    LayerNorm (not SDXL's penultimate one)."""
    jdrv, tdrv, *_ = drivers
    _close(tdrv.edit_prompt_emb.numpy(), jdrv.edit_prompt_emb)
    ids = torch.as_tensor(tdrv.tokenizer(["a test prompt"]), dtype=torch.long)
    with torch.no_grad():
        assert not torch.equal(tdrv.text_model(ids, penultimate=True),
                               tdrv.edit_prompt_emb)


def _jax_pullback(jdrv, zt, t, v_init):
    enc, enc_vjp, tag = jdrv._pullback_tap_encoders(JTap("mid"))
    p, emb = jdrv.unet_params, jdrv.edit_prompt_emb
    res, h = jax.jit(lambda zz, v0: (jlocal_pullback(
        lambda q: enc(p, q, t, emb), zz, jax.random.key(0), v_init=v0,
        pca_rank=RANK, min_iter=2, max_iter=2, atol=0.0,
        fn_vjp=lambda q: enc_vjp(p, q, t, emb)), enc(p, zz, t, emb)))(
            jnp.asarray(zt), jnp.asarray(v_init))
    return res, h, tag


def test_tapped_h_and_mid_tap_pullback_on_the_pair_match_jax(drivers, plain_shapes):
    """The mid-tap encoder's h and its pullback on the fused pair (JAX:
    flash_jvp / flash in interpret mode; the port: K2–K5's plain versions,
    K3–K5 with the 2 probes folded into B·H), from the same v_init and 2
    iterations."""
    jdrv, tdrv, zt, t, v_init = drivers
    ref, h_ref, jtag = _jax_pullback(jdrv, zt, t, v_init)
    enc, enc_vjp, tag = tdrv._pullback_tap_encoders(torch.tensor(float(t)),
                                                    TapPoint("mid"))
    assert tag == jtag == "flashpair"
    with torch.no_grad():
        _close(enc(torch.from_numpy(zt)).numpy(), h_ref)
    res = local_pullback(enc, torch.from_numpy(zt), v_init=torch.from_numpy(v_init),
                         fn_vjp=enc_vjp, pca_rank=RANK, min_iter=2, max_iter=2,
                         atol=0.0)
    np.testing.assert_allclose(res.s.numpy(), np.asarray(ref.s), rtol=1e-3)
    cos = np.abs(np.sum(res.vT.numpy() * np.asarray(ref.vT), axis=1))
    assert cos.min() >= 0.99, cos
    # the encoder reaches one 1024-token self-attention of 2 heads
    assert {c[2] for c in plain_shapes["flash_tangent_plain"]} == {1024}
    assert {c[1] for c in plain_shapes["flash_tangent_plain"]} == {2 * RANK}
    assert plain_shapes["flash_dq_plain"] and plain_shapes["flash_dkv_plain"]


def test_port_driver_runs_the_encoder_pullback_edit(drivers, plain_shapes):
    """run_edit_local_encoder_pullback_zt on the SD 1.5 modules handed to
    the port's driver: finite PNGs of both directions, the pullback on the
    fused pair (K2–K5's plain versions at 1024 tokens)."""
    _, tdrv, *_ = drivers
    names = tdrv.run_edit_local_encoder_pullback_zt(idx=0, pca_rank=RANK, vis_num=2,
                                                    vis_num_pc=1)
    assert len(names) == 2
    assert all(os.path.exists(os.path.join(tdrv.cfg.result_folder, n + ".png"))
               for n in names)
    assert all(plain_shapes[k] for k in ("flash_forward_lse_plain", "flash_tangent_plain",
                                         "flash_dq_plain", "flash_dkv_plain"))


# ---- full-width layouts on the meta device --------------------------------

CTX = {768: jnp.zeros((1, 77, 768)), 1024: jnp.zeros((1, 77, 1024))}
IDS = jnp.zeros((1, 77), jnp.int32)


@pytest.mark.parametrize("which,n_params", [
    ("sd15_unet", 859_520_964), ("sd15_text_encoder", 123_060_480),
    ("sd21_base_unet", 865_910_724), ("sd_vae", 83_653_863),
    ("sd21_text_encoder", 340_387_840), ("adm_imagenet128_cond", 421_529_606)])
def test_full_width_layout_matches_jax(which, n_params):
    jc, build = getattr(jcfg, which)(), getattr(tmodels, which)
    if which.endswith("_unet"):
        theirs = jax_layout(JUNet(jc), False, jnp.zeros((1, 8, 8, 4)), jnp.float32(0.0),
                            CTX[jc.cross_attention_dim])
        mine = port_layout(lambda: tmodels.UNet2DCondition(build()))
    elif which.endswith("_text_encoder"):
        theirs = jax_layout(JCLIP(jc), True, IDS)
        mine = port_layout(lambda: tmodels.CLIPTextModel(build()))
    elif which == "sd_vae":
        theirs = jax_layout(JVAE(jc), False, jnp.zeros((1, 64, 64, 3)))
        mine = port_layout(lambda: tmodels.AutoencoderKL(build()))
    else:
        theirs = jax_layout(jadm.UNetADM(jc), False, jnp.zeros((1, 128, 128, 3)),
                            jnp.float32(0.0), y=jnp.zeros((1,), jnp.int32))
        mine = port_layout(lambda: tmodels.UNetADM(build()))
    assert mine == theirs
    assert sum(int(np.prod(s)) for s in mine.values()) == n_params


def test_sd15_self_attention_calls_per_pass(plain_shapes):
    """sd15_unet's blocks at 64² latents with narrow channels (one head of 8
    at every block): a pass runs K1's plain version 5 times at 4096 tokens
    (down block 0: 2, up block 3: 3) and 5 times at 1024 (down block 1: 2,
    up block 2: 3); the 256- and 64-token layers and the 77-token
    cross-attention take the math path; the encoder to the mid tap 2 and 2.
    chip_smoke.py's launch counts assume these."""
    import dataclasses

    cfg = dataclasses.replace(
        tmodels.sd15_unet(attn_impl="flash"), block_out_channels=(8, 8, 8, 8),
        attention_heads=(1, 1, 1, 1), attention_head_dim=8, cross_attention_dim=8,
        norm_num_groups=4)
    m = tmodels.UNet2DCondition(cfg).requires_grad_(False)
    x, ctx = torch.zeros(1, 4, 64, 64), torch.zeros(1, 77, 8)
    count = lambda: {s: sum(1 for c in plain_shapes["flash_forward_plain"] if c[2] == s)
                     for s in (4096, 1024)}
    m(x, 500.0, ctx)
    assert count() == {4096: 5, 1024: 5}
    assert len(plain_shapes["flash_forward_plain"]) == 10
    plain_shapes["flash_forward_plain"].clear()
    m.encode(x, 500.0, ctx, TapPoint("mid"))
    assert count() == {4096: 2, 1024: 2}
