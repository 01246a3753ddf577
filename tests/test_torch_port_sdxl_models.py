"""The port's SDXL models against the JAX package on the CPU, f32, weights
carried by load_flax_params: the U-Net with addition embeddings (ε at batch
1 and at batch 3 with a broadcast pooled embedding, the tapped h at every
tap, the state's resumption, the missing-added_cond error), the two text
towers (CLIP ViT-L with quick_gelu and no projection, OpenCLIP bigG with
gelu and the pooled projection: hidden, penultimate and pooled), and the
full-width layout of sdxl_base_unet and both towers, built on the meta
device, against the JAX package's own torch export of its jax.eval_shape
tree (no array is allocated); and the SDXL U-Net's self-attention calls per
pass by token count, on its block layout at narrow widths, which
chip_smoke.py's launch counts assume.

Gates: ε and every output within 1e-5 (atol 1e-5 of max(1, max |ref|) and
rtol 1e-5 for the taps, whose f32 roundoff grows with |h|, as in
tests/test_torch_port_sd_state.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import (  # noqa: F401
    flax_params,
    jax_layout,
    nchw,
    nhwc,
    one_torch_thread,
    plain_shapes,
    port_layout,
)

from diffusion_pullback_tpu.models import configs as jcfg
from diffusion_pullback_tpu.models.clip_text import CLIPTextModel as JCLIP
from diffusion_pullback_tpu.models.clip_text import HashTokenizer
from diffusion_pullback_tpu.models.unet2d import TapPoint as JTap
from diffusion_pullback_tpu.models.unet2d_condition import UNet2DCondition as JUNet
from diffusion_pullback_tpu_torch.models import (
    CLIPTextModel,
    TapPoint,
    UNet2DCondition,
    clip_text_tiny,
    load_flax_params,
    sdxl_base_unet,
    sdxl_text_encoder_1,
    sdxl_text_encoder_2,
    sdxl_tiny_unet,
)

T = np.float32(437.0)
TAPS = [("down", 0), ("down", 1), ("mid", 0), ("up", 0), ("up", 1)]
INNER = [("down", 1, ("res", 0)), ("down", 1, ("attn", 0))]


def close(out, ref, msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=1e-5 * max(1.0, float(np.abs(ref).max())),
                               err_msg=str(msg))


@pytest.fixture(scope="module")
def unets():
    """(JAX module, params, port module, x (3 rows), context, pooled,
    time_ids), the pooled embedding and time_ids of one row."""
    jm = JUNet(jcfg.sdxl_tiny_unet(8))
    rng = np.random.default_rng(51)
    x = rng.normal(size=(3, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(size=(1, 8, 16)).astype(np.float32)
    pooled = rng.normal(size=(1, 8)).astype(np.float32)
    time_ids = np.asarray([[64.0, 64.0, 0.0, 0.0, 64.0, 64.0]], np.float32)
    params = flax_params(jm, jnp.asarray(x), jnp.float32(0.0), jnp.asarray(ctx),
                         added_cond=(jnp.asarray(pooled), jnp.asarray(time_ids)))
    tm = load_flax_params(UNet2DCondition(sdxl_tiny_unet(8)), params)
    return jm, params, tm.requires_grad_(False), x, ctx, pooled, time_ids


def _added(pooled, time_ids, b, cast):
    return (cast(np.broadcast_to(pooled, (b, pooled.shape[1])).copy()),
            cast(np.broadcast_to(time_ids, (b, 6)).copy()))


@pytest.mark.parametrize("b", [1, 3], ids=["batch1", "batch3-broadcast"])
def test_eps_with_addition_embeddings_matches_jax(unets, b):
    """At batch 3 one row of pooled embedding and time_ids broadcasts."""
    jm, params, tm, x, ctx, pooled, time_ids = unets
    rows = 1
    ref = jm.apply(params, jnp.asarray(x[:b]), T, jnp.asarray(ctx),
                   added_cond=_added(pooled, time_ids, rows, jnp.asarray))
    out = tm(nchw(x[:b]), torch.tensor(T), torch.from_numpy(ctx),
             _added(pooled, time_ids, rows, torch.from_numpy))
    assert out.shape == (b, 4, 8, 8)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=1e-5)


def test_addition_embeddings_change_eps(unets):
    """The pooled embedding reaches ε (a port that dropped it would agree
    with JAX only where JAX dropped it too)."""
    _, _, tm, x, ctx, pooled, time_ids = unets
    run = lambda p: tm(nchw(x[:1]), torch.tensor(T), torch.from_numpy(ctx),
                       (torch.from_numpy(p), torch.from_numpy(time_ids)))
    assert (run(pooled) - run(pooled + 1.0)).abs().max() > 1e-3


@pytest.mark.parametrize("tap", TAPS + INNER, ids=str)
def test_tapped_h_matches_jax(unets, tap):
    """encode at every tap (the inner ones of the cross-attention block
    too); at the block taps also the state's time embedding and skips, and
    decode_with_state from it back to ε."""
    jm, params, tm, x, ctx, pooled, time_ids = unets
    j_added, t_added = (_added(pooled, time_ids, 1, f)
                        for f in (jnp.asarray, torch.from_numpy))
    jh, jstate = jm.apply(params, jnp.asarray(x), T, jnp.asarray(ctx), JTap(*tap),
                          added_cond=j_added, method=JUNet.encode_with_state)
    th, tstate = tm.encode_with_state(nchw(x), torch.tensor(T),
                                      torch.from_numpy(ctx), TapPoint(*tap), t_added)
    close(nhwc(th), jh, tap)
    close(tm.encode(nchw(x), torch.tensor(T), torch.from_numpy(ctx),
                    TapPoint(*tap), t_added).numpy(), nchw(np.asarray(jh)).numpy(), tap)
    close(tstate.emb.numpy(), jstate.emb, "emb")
    if len(tap) == 3:
        return
    assert len(tstate.skips) == len(jstate.skips)
    for a, b in zip(tstate.skips, jstate.skips):
        close(nhwc(a), b, tap)
    ref = jm.apply(params, jh, jstate, JTap(*tap), method=JUNet.decode_with_state)
    close(nhwc(tm.decode_with_state(th, tstate, TapPoint(*tap))), ref, tap)


def test_shallow_encode_matches_jax(unets):
    jm, params, tm, x, ctx, pooled, time_ids = unets
    ref = jm.apply(params, jnp.asarray(x), T, jnp.asarray(ctx),
                   added_cond=_added(pooled, time_ids, 1, jnp.asarray),
                   method=JUNet.shallow_encode)
    out = tm.shallow_encode(nchw(x), torch.tensor(T), torch.from_numpy(ctx),
                            _added(pooled, time_ids, 1, torch.from_numpy))
    close(out.emb.numpy(), ref.emb)
    for a, b in zip(out.skips, ref.skips):
        close(nhwc(a), b)


def test_missing_added_cond_raises(unets):
    jm, params, tm, x, ctx, _, _ = unets
    with pytest.raises(ValueError, match="added_cond"):
        jm.apply(params, jnp.asarray(x[:1]), T, jnp.asarray(ctx))
    for call in (lambda: tm(nchw(x[:1]), torch.tensor(T), torch.from_numpy(ctx)),
                 lambda: tm.encode(nchw(x[:1]), torch.tensor(T), torch.from_numpy(ctx),
                                   TapPoint("mid")),
                 lambda: tm.shallow_encode(nchw(x[:1]), torch.tensor(T),
                                           torch.from_numpy(ctx))):
        with pytest.raises(ValueError, match="added_cond"):
            call()


TOWER = dataclasses.replace(clip_text_tiny(), hidden_size=8, intermediate_size=16)


@pytest.mark.parametrize("act,projection", [("quick_gelu", False), ("gelu", True)],
                         ids=["clip-L-like", "bigG-like"])
def test_tower_outputs_match_jax(act, projection):
    cfg = dataclasses.replace(TOWER, hidden_act=act)
    jm = JCLIP(dataclasses.replace(jcfg.clip_text_tiny(), hidden_size=8,
                                   intermediate_size=16, hidden_act=act))
    ids = HashTokenizer(cfg.vocab_size, cfg.max_length)(
        ["a photo of a tree", "", "sitting dog"])
    params = flax_params(jm, jnp.zeros((1, cfg.max_length), jnp.int32), seed=3,
                         return_pooled=projection)
    tm = load_flax_params(CLIPTextModel(cfg, projection=projection), params)
    tids = torch.from_numpy(ids).long()
    with torch.no_grad():
        np.testing.assert_allclose(tm(tids).numpy(), jm.apply(params, ids), atol=1e-5)
        np.testing.assert_allclose(tm(tids, penultimate=True).numpy(),
                                   jm.apply(params, ids, penultimate=True), atol=1e-5)
        final = tm(tids).numpy()
        assert np.abs(tm(tids, penultimate=True).numpy() - final).max() > 1e-2
        if not projection:
            assert not hasattr(tm, "text_projection")
            return
        for pen in (False, True):
            h, pooled = tm(tids, return_pooled=True, penultimate=pen)
            jh, jpooled = jm.apply(params, ids, return_pooled=True, penultimate=pen)
            np.testing.assert_allclose(h.numpy(), jh, atol=1e-5)
            np.testing.assert_allclose(pooled.numpy(), jpooled, atol=1e-5)
            assert pooled.shape == (3, 8)


def test_sdxl_base_unet_layout_matches_jax():
    cfg = jcfg.sdxl_base_unet()
    theirs = jax_layout(JUNet(cfg), False, jnp.zeros((1, 8, 8, 4)), jnp.float32(0.0),
                         jnp.zeros((1, 77, 2048)),
                         added_cond=(jnp.zeros((1, 1280)), jnp.zeros((1, 6))))
    mine = port_layout(lambda: UNet2DCondition(sdxl_base_unet()))
    assert mine == theirs
    assert mine["add_embedding.linear_1.weight"] == (1280, 2816)
    n = sum(int(np.prod(s)) for s in mine.values())
    assert abs(n / 1e9 - 2.567) < 0.001, n


@pytest.mark.parametrize("tower,projection,hidden", [
    (sdxl_text_encoder_1, False, 768), (sdxl_text_encoder_2, True, 1280)],
    ids=["clip-L", "bigG"])
def test_sdxl_tower_layout_matches_jax(tower, projection, hidden):
    jtower = {768: jcfg.sdxl_text_encoder_1, 1280: jcfg.sdxl_text_encoder_2}[hidden]()
    theirs = jax_layout(JCLIP(jtower), True, jnp.zeros((1, 77), jnp.int32),
                         return_pooled=projection)
    mine = port_layout(lambda: CLIPTextModel(tower(), projection=projection))
    assert mine == theirs
    assert ("text_projection.weight" in mine) == projection
    assert mine["text_model.final_layer_norm.weight"] == (hidden,)


def test_sdxl_self_attention_calls_per_pass(plain_shapes):
    """sdxl_base_unet's blocks (depths 1, 2, 10; two layers down, three up;
    the mid block at the last depth) at 128² latents with narrow channels
    and one 8-wide head per block: a pass runs K1's plain version 10 times
    at 4096 tokens (down 1: 2×2, up 1: 3×2) and 60 times at 1024 (down 2:
    2×10, mid: 10, up 0: 3×10); the encoder to the mid tap 4 and 30 times.
    The 77-token cross-attention stays on the math path."""
    cfg = dataclasses.replace(
        sdxl_base_unet(attention_head_dim=8, norm_num_groups=8, attn_impl="flash"),
        block_out_channels=(32, 32, 32), attention_heads=(1, 1, 1),
        cross_attention_dim=8, addition_embed_dim=8, addition_time_embed_dim=4)
    m = UNet2DCondition(cfg).requires_grad_(False)
    x, ctx = torch.zeros(1, 4, 128, 128), torch.zeros(1, 77, 8)
    added = (torch.zeros(1, 8), torch.zeros(1, 6))
    count = lambda: {s: sum(1 for c in plain_shapes["flash_forward_plain"] if c[2] == s)
                     for s in (4096, 1024)}
    m(x, 500.0, ctx, added)
    assert count() == {4096: 10, 1024: 60}
    plain_shapes["flash_forward_plain"].clear()
    m.encode(x, 500.0, ctx, TapPoint("mid"), added)
    assert count() == {4096: 4, 1024: 30}
    assert len(plain_shapes["flash_forward_plain"]) == 34
