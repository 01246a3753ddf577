"""The uncond driver of the port on an ADM net against the JAX package's,
on the CPU in float32: a tiny UNetADM whose 32² level and mid block
self-attend over 1024 tokens with one head of 64 (torch_port_common.
adm_driver_pair), shared weights moved by load_flax_params. The mid-tap
pullback on the fused pair (the port's plain versions of K2–K5, counted by
shape) against the JAX pair in interpret mode from the same v_init; the
driver's choice of pullback encoders; and the edit PNGs within one uint8
level of the JAX driver's on one basis, with the port's sampling on K1's
plain version. (Guidance and respacing through the drivers:
tests/test_torch_port_adm_cli.py.)

Gates: σ rtol 1e-3 and |cos| ≥ 0.99 for bases; PNGs within one level."""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_port_common import (  # noqa: F401
    adm_driver_pair,
    one_torch_thread,
    plain_shapes,
)

from diffusion_pullback_tpu.geometry import local_pullback as jlocal_pullback
from diffusion_pullback_tpu.models.unet2d import TapPoint as JTap
from diffusion_pullback_tpu_torch import experiments as texp
from diffusion_pullback_tpu_torch import models as tmodels
from diffusion_pullback_tpu_torch.experiments._common import to_nchw, to_nhwc
from diffusion_pullback_tpu_torch.geometry import local_pullback
from diffusion_pullback_tpu_torch.models import TapPoint

CFG = dict(for_steps=8, inv_steps=8, edit_t=0.6, pca_rank=2, pullback_min_iter=0,
           pullback_max_iter=1, x_space_guidance_num_step=2,
           x_space_guidance_scale=0.5, vis_num=2, vis_num_pc=1,
           use_performance_boosting=False)
RANK = 2


@pytest.fixture(scope="module")
def drivers(tmp_path_factory):
    return adm_driver_pair(tmp_path_factory.mktemp("adm"), CFG)


@pytest.mark.parametrize("impl", ["xla", "flash"], ids=["math", "pair"])
def test_mid_tap_pullback_matches_jax(drivers, plain_shapes, monkeypatch, impl):
    """On the pair the encoder's two 1024-token self-attentions (level 1
    and the mid block, one head at batch 1) run K2–K5's plain versions: 2
    iterations and the final u give 3 tangent passes (K2, K3 with the
    probes folded into B·H), one vjp (K2) and 2 cotangent passes (K4,
    K5)."""
    jdrv, tdrv = drivers
    for drv in (jdrv, tdrv):
        monkeypatch.setattr(drv.cfg, "pullback_attn_impl", impl)
    rng = np.random.default_rng(31)
    xt = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
    v_init = np.linalg.qr(rng.normal(size=(xt.size, RANK)))[0].T.astype(np.float32)
    t = float(jdrv.fwd_grid.timesteps[jdrv.edit_t_idx])
    m_jvp, m_vjp = jdrv._pullback_models()
    enc = lambda m: (lambda q: m.apply(jdrv.params, q, jnp.float32(t), JTap("mid"),
                                       method=type(m).encode))
    ref = jax.jit(lambda zz, v0: jlocal_pullback(
        enc(m_jvp), zz, jax.random.key(0), v_init=v0, pca_rank=RANK, min_iter=2,
        max_iter=2, atol=0.0, fn_vjp=m_vjp and enc(m_vjp)))(
        jnp.asarray(xt), jnp.asarray(v_init))

    e_jvp, e_vjp, tag = tdrv._pullback_models()
    nhwc_enc = lambda e: e and (lambda z: to_nhwc(e(to_nchw(z), torch.tensor(t),
                                                    TapPoint("mid"))))
    res = local_pullback(nhwc_enc(e_jvp), torch.from_numpy(xt),
                         v_init=torch.from_numpy(v_init), fn_vjp=nhwc_enc(e_vjp),
                         pca_rank=RANK, min_iter=2, max_iter=2, atol=0.0)
    assert tag == ("flashpair" if impl == "flash" else "xla")
    assert res.iterations == int(ref.iterations) == 2
    np.testing.assert_allclose(res.s.numpy(), np.asarray(ref.s), rtol=1e-3)
    cos = np.abs(np.sum(res.vT.numpy() * np.asarray(ref.vT), axis=1))
    assert cos.min() >= 0.99, cos
    if impl == "xla":
        assert not any(plain_shapes.values())
        return
    assert plain_shapes == {
        "flash_forward_plain": [],
        "flash_forward_lse_plain": [(1, 1, 1024)] * 2 * 4,
        "flash_tangent_plain": [(1, RANK, 1024)] * 2 * 3,
        "flash_dq_plain": [(1, RANK, 1024)] * 2 * 2,
        "flash_dkv_plain": [(1, RANK, 1024)] * 2 * 2}


@pytest.mark.parametrize("pullback,model_attn,tag", [
    ("", "flash", "flashpair"), ("flash", "xla", "flashpair"), ("", "xla", "xla"),
    ("xla", "flash", "xla"), ("blockwise", "xla", "blockwise")])
def test_pullback_models_select_the_pair(drivers, monkeypatch, pullback, model_attn, tag):
    """The JAX driver's _pullback_models rule: the pair when the net samples
    with 'flash' or pullback_attn_impl asks for it, else that impl (or the
    net's own); a DDPM UNet2D has no switch."""
    _, tdrv = drivers
    monkeypatch.setattr(tdrv.cfg, "pullback_attn_impl", pullback)
    monkeypatch.setattr(tdrv.model, "config",
                        dataclasses.replace(tdrv.model.config, attn_impl=model_attn))
    enc, enc_vjp, got = tdrv._pullback_models()
    assert got == tag and (enc_vjp is not None) == (tag == "flashpair")
    ddpm = texp.EditUncondDiffusion(
        tmodels.UNet2D(tmodels.ddpm_tiny(8)), tdrv.schedule, tdrv.dataset,
        texp.UncondExperimentConfig(basis_folder=tdrv.cfg.basis_folder),
        logger=tdrv.log, device="cpu")
    assert ddpm._pullback_models()[1:] == (None, "xla")


def test_edit_pngs_match_jax_within_one_level(drivers, plain_shapes):
    """The JAX driver computes the basis and its PNGs; the port edits from
    the same basis file, sampling with 'flash' (K1's plain version at
    1024 tokens: four self-attentions per pass)."""
    jdrv, tdrv = drivers
    jnames = jdrv.run_edit_local_encoder_pullback_xt(idx=0)
    basis = os.listdir(jdrv.cfg.basis_folder)
    assert len(basis) == 1
    os.makedirs(tdrv.cfg.basis_folder, exist_ok=True)
    shutil.copy(os.path.join(jdrv.cfg.basis_folder, basis[0]), tdrv.cfg.basis_folder)
    tnames = tdrv.run_edit_local_encoder_pullback_xt(idx=0)
    assert tnames == jnames and len(tnames) == 2
    for n in tnames:
        a, b = (np.asarray(Image.open(os.path.join(d.cfg.result_folder, n + ".png")),
                           np.int16) for d in (tdrv, jdrv))
        assert a.shape == b.shape == (64, 3 * 64, 3)
        assert np.abs(a - b).max() <= 1, n
    k1 = plain_shapes["flash_forward_plain"]
    assert k1 and set(k1) <= {(b, b, 1024) for b in (1, 4, 6)}
    assert not plain_shapes["flash_tangent_plain"]   # the basis came from the cache
