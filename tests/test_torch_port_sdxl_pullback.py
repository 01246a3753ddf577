"""The encoder pullback of the port's SDXL driver against the JAX package's
on the CPU, f32, on shared weights (torch_port_common.sdxl_driver_pair at
64² latents: the cross-attention level self-attends over 1024 tokens, so
the mid-tap encoder reaches the fused pair), from the same injected
v_init and a fixed number of iterations, on the math path and on the
pair's plain versions, with CFG inside the JVP at 7.5 and without. The
edit and negative prompts differ, and so do their pooled embeddings, so a
probe paired with the wrong CFG half, or a pooled row stacked against the
wrong context row, would show.

Gates: σ rtol 1e-3 and |cos| ≥ 0.99 per direction."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread, plain_shapes, sdxl_driver_pair  # noqa: F401

from diffusion_pullback_tpu.geometry import local_pullback as jlocal_pullback
from diffusion_pullback_tpu.models.unet2d import TapPoint as JTap
from diffusion_pullback_tpu_torch.geometry import local_pullback
from diffusion_pullback_tpu_torch.models import TapPoint

SCALE = 7.5
RANK = 2
CFG = dict(dataset_name="noise", for_steps=8, inv_steps=8, edit_t=0.6,
           edit_prompt="a test prompt", neg_prompt="ugly", pca_rank=RANK,
           pullback_min_iter=2, pullback_max_iter=2, pullback_atol=0.0)


@pytest.fixture(scope="module")
def drivers(tmp_path_factory):
    """(JAX driver, port driver, z_t, t, v_init) on shared weights."""
    jdrv, tdrv = sdxl_driver_pair(tmp_path_factory.mktemp("xl_pb"), CFG, size=64)
    rng = np.random.default_rng(71)
    zt = rng.normal(size=(1, 64, 64, 4)).astype(np.float32)
    v_init = np.linalg.qr(rng.normal(size=(zt.size, RANK)))[0].T.astype(np.float32)
    return jdrv, tdrv, zt, jdrv.fwd_grid.timesteps[jdrv.edit_t_idx], v_init


def _jax_pullback(jdrv, zt, t, v_init, cfg_on):
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


@pytest.mark.parametrize("impl,scale", [("xla", SCALE), ("flash", SCALE), ("flash", 0.0)],
                         ids=["math-cfg", "pair-cfg", "pair"])
def test_encoder_pullback_matches_jax(drivers, plain_shapes, monkeypatch, impl, scale):
    """On the pair the encoder's four 1024-token self-attentions (the
    2-deep transformers of down block 1 and of the mid block, both at 32²)
    run K2–K5's plain versions: with CFG the 2·B primal (B·H = 2·2 heads)
    and the probes folded outside it (B·H = 2·4); 2 iterations and the
    final u give 3 tangent passes (K2, K3), one vjp (K2) and 2 cotangent
    passes (K4, K5)."""
    jdrv, tdrv, zt, t, v_init = drivers
    for drv in (jdrv, tdrv):
        monkeypatch.setattr(drv.cfg, "pullback_attn_impl", impl)
        monkeypatch.setattr(drv.cfg, "pullback_guidance_scale", scale)
    ref = _jax_pullback(jdrv, zt, t, v_init, cfg_on=scale > 0)
    enc, enc_vjp, tag = tdrv._pullback_tap_encoders(torch.tensor(float(t)),
                                                    TapPoint("mid"))
    res = local_pullback(enc, torch.from_numpy(zt), v_init=torch.from_numpy(v_init),
                         fn_vjp=enc_vjp, pca_rank=RANK, min_iter=2, max_iter=2,
                         atol=0.0)
    assert tag == ("flashpair" if impl == "flash" else "xla") + (
        f"_cfg{scale}" if scale else "")
    assert res.iterations == int(ref.iterations) == 2
    np.testing.assert_allclose(res.s.numpy(), np.asarray(ref.s), rtol=1e-3)
    cos = np.abs(np.sum(res.vT.numpy() * np.asarray(ref.vT), axis=1))
    assert cos.min() >= 0.99, cos
    if impl == "xla":
        assert not any(plain_shapes.values())
        return
    bh = 2 * (2 if scale else 1)
    assert plain_shapes == {
        "flash_forward_plain": [],
        "flash_forward_lse_plain": [(bh, bh, 1024)] * 4 * 4,
        "flash_tangent_plain": [(bh, RANK * bh, 1024)] * 4 * 3,
        "flash_dq_plain": [(bh, RANK * bh, 1024)] * 4 * 2,
        "flash_dkv_plain": [(bh, RANK * bh, 1024)] * 4 * 2}
