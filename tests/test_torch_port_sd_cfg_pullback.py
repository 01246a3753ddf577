"""CFG inside the JVP (BASELINE config 4) in the port's SD driver against
the JAX package's, on the CPU at f32 with the weights carried by
load_flax_params: the tiny U-Net at 32×32 latents, whose first block
self-attends over 1024 tokens and so reaches the fused pair. The edit and
negative prompts differ, so a probe paired with the wrong CFG half would
show.

Gates: each prompt's encoder to atol 1e-5 and the fused 2·B encoder to
the bound that propagates through its extrapolation; the CFG pullback, math path and
pair, from the same v_init and a fixed number of iterations, σ rtol 1e-3
and |cos| ≥ 0.99 per direction; scale 0 gives the edit-prompt encoder's
basis; the basis-name qualifiers equal the JAX driver's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread, plain_shapes, sd_driver_pair  # noqa: F401

from diffusion_pullback_tpu.geometry import local_pullback as jlocal_pullback
from diffusion_pullback_tpu.models.unet2d import TapPoint as JTap
from diffusion_pullback_tpu_torch.geometry import local_pullback
from diffusion_pullback_tpu_torch.models import TapPoint

SCALE = 2.5
RANK = 3
CFG = dict(dataset_name="noise", for_steps=8, inv_steps=8, edit_t=0.6,
           edit_prompt="a test prompt", neg_prompt="ugly", pca_rank=RANK,
           pullback_min_iter=2, pullback_max_iter=2, pullback_atol=0.0,
           pullback_guidance_scale=SCALE)


@pytest.fixture(scope="module")
def drivers(tmp_path_factory):
    """(JAX driver, port driver, z_t, t, v_init) on shared weights."""
    jdrv, tdrv = sd_driver_pair(tmp_path_factory.mktemp("cfg"), CFG)
    rng = np.random.default_rng(21)
    zt = rng.normal(size=(1, 32, 32, 4)).astype(np.float32)
    v_init = np.linalg.qr(rng.normal(size=(zt.size, RANK)))[0].T.astype(np.float32)
    t = jdrv.fwd_grid.timesteps[jdrv.edit_t_idx]
    return jdrv, tdrv, zt, t, v_init


def _agree(res, ref):
    np.testing.assert_allclose(res.s.numpy(), np.asarray(ref.s), rtol=1e-3)
    cos = np.abs(np.sum(res.vT.numpy() * np.asarray(ref.vT), axis=1))
    assert cos.min() >= 0.99, cos


def _jax_pullback(jdrv, zt, t, v_init, cfg_on=True):
    """The JAX driver's compute_local_basis composition with v_init."""
    enc, enc_vjp, _ = jdrv._pullback_tap_encoders(JTap("mid"))
    embs = jdrv.edit_prompt_emb
    if cfg_on:
        enc = jdrv._cfg_encoder(enc)
        enc_vjp = enc_vjp and jdrv._cfg_encoder(enc_vjp)
        embs = (jdrv.edit_prompt_emb, jdrv.neg_prompt_emb)
    p = jdrv.unet_params
    return jax.jit(lambda zz, v0: jlocal_pullback(
        lambda q: enc(p, q, t, embs), zz, jax.random.key(0), v_init=v0,
        pca_rank=RANK, min_iter=2, max_iter=2, atol=0.0,
        fn_vjp=enc_vjp and (lambda q: enc_vjp(p, q, t, embs))))(
        jnp.asarray(zt), jnp.asarray(v_init))


def _port_pullback(tdrv, zt, t, v_init):
    enc, enc_vjp, tag = tdrv._pullback_tap_encoders(torch.tensor(float(t)),
                                                    TapPoint("mid"))
    res = local_pullback(enc, torch.from_numpy(zt), v_init=torch.from_numpy(v_init),
                         fn_vjp=enc_vjp, pca_rank=RANK, min_iter=2, max_iter=2,
                         atol=0.0)
    return res, tag


def test_fused_cfg_encoder_matches_jax(drivers):
    """Each prompt's encoder within 1e-5 of max |h| of the JAX one (f32
    roundoff grows with the features' scale; |h| reaches ≈ 10 at this
    tap); the fused 2·B extrapolation, against the port's two halves
    combined and against the JAX package's fused encoder, within (1 + 2s)
    times that bound, as the extrapolation propagates it."""
    jdrv, tdrv, zt, t, _ = drivers
    jenc, _, _ = jdrv._pullback_tap_encoders(JTap("mid"))
    jhalf = {k: np.asarray(jenc(jdrv.unet_params, jnp.asarray(zt), t, e))
             for k, e in (("edit", jdrv.edit_prompt_emb), ("neg", jdrv.neg_prompt_emb))}
    ref = np.asarray(jdrv._cfg_encoder(jenc)(
        jdrv.unet_params, jnp.asarray(zt), t,
        (jdrv.edit_prompt_emb, jdrv.neg_prompt_emb)))
    tt = torch.tensor(float(t))
    enc, enc_vjp, tag = tdrv._pullback_tap_encoders(tt, TapPoint("mid"))
    assert tag == f"xla_cfg{SCALE}" and enc_vjp is None
    one = tdrv._encoder(tt, TapPoint("mid"), "xla")
    z = torch.from_numpy(zt)
    with torch.no_grad():
        fused = enc(z).numpy()
        half = {"edit": one(z, tdrv.edit_prompt_emb).numpy(),
                "neg": one(z, tdrv.neg_prompt_emb).numpy()}
    bound = 1e-5 * max(np.abs(h).max() for h in jhalf.values())
    assert bound < 2e-4
    for k in half:
        np.testing.assert_allclose(half[k], jhalf[k], atol=bound, err_msg=k)
    np.testing.assert_allclose(fused, (1 + SCALE) * half["edit"] - SCALE * half["neg"],
                               atol=(1 + 2 * SCALE) * bound)
    np.testing.assert_allclose(fused, ref, atol=(1 + 2 * SCALE) * bound)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_cfg_pullback_matches_jax(drivers, impl, plain_shapes, monkeypatch):
    """The CFG pullback on the math path and on the fused pair. The pair's
    K2–K5 see the 2·B primal (B·H = 2·2 heads) and K3–K5 the probes folded
    outside it (B·H = 3·4)."""
    jdrv, tdrv, zt, t, v_init = drivers
    monkeypatch.setattr(jdrv.cfg, "pullback_attn_impl", impl)
    monkeypatch.setattr(tdrv.cfg, "pullback_attn_impl", impl)
    ref = _jax_pullback(jdrv, zt, t, v_init)
    res, tag = _port_pullback(tdrv, zt, t, v_init)
    assert tag == ("flashpair" if impl == "flash" else "xla") + f"_cfg{SCALE}"
    assert res.iterations == int(ref.iterations) == 2
    _agree(res, ref)
    if impl == "flash":
        # 2 iterations + the final u: K2 and K3 once per tangent pass, K2
        # once for the vjp, K4 and K5 once per iteration, each on the one
        # 1024-token self-attention of the encoder
        assert plain_shapes == {
            "flash_forward_plain": [],
            "flash_forward_lse_plain": [(4, 4, 1024)] * 4,
            "flash_tangent_plain": [(4, 12, 1024)] * 3,
            "flash_dq_plain": [(4, 12, 1024)] * 2,
            "flash_dkv_plain": [(4, 12, 1024)] * 2}
    else:
        assert not any(plain_shapes.values())


def test_zero_scale_gives_the_edit_prompt_basis(drivers, monkeypatch):
    """Scale 0 differentiates the edit-prompt encoder alone: the port's
    basis equals the JAX driver's plain one, and its tag has no CFG."""
    jdrv, tdrv, zt, t, v_init = drivers
    monkeypatch.setattr(tdrv.cfg, "pullback_guidance_scale", 0.0)
    res, tag = _port_pullback(tdrv, zt, t, v_init)
    assert tag == "xla"
    _agree(res, _jax_pullback(jdrv, zt, t, v_init, cfg_on=False))


@pytest.mark.parametrize("scale", [0.0, SCALE])
@pytest.mark.parametrize("inner", [None, ("res", 1), ("attn", 1)])
def test_basis_name_extras_match_jax(drivers, monkeypatch, scale, inner):
    jdrv, tdrv, *_ = drivers
    monkeypatch.setattr(jdrv.cfg, "pullback_guidance_scale", scale)
    monkeypatch.setattr(tdrv.cfg, "pullback_guidance_scale", scale)
    mine = tdrv._basis_name_extras(TapPoint("down", 0, inner))
    assert mine == jdrv._basis_name_extras(JTap("down", 0, inner))
    assert mine == (f"-after_{inner[0]}1" if inner else "") + (
        f"-cfg{scale}" if scale else "")


def test_make_tap_moves_after_the_last_layer(drivers):
    """SD's intra-block taps sit after the block's last resnet /
    self-attention, as the JAX driver's _make_tap puts them."""
    jdrv, tdrv, *_ = drivers
    for kw in (dict(after_res=True), dict(after_sa=True), {}):
        mine, theirs = tdrv._make_tap("down", 0, **kw), jdrv._make_tap("down", 0, **kw)
        assert tuple(mine) == tuple(theirs)
