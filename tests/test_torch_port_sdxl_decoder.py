"""The decoder-pullback edits and DeepCache of the port's SDXL driver
against the JAX package's EditStableDiffusionXL on the CPU, f32, on shared
weights (torch_port_common.sdxl_driver_pair at 8² latents, 16 px images):
run_edit_local_decoder_pullback_zt (∂ε/∂h and ∂ẑ₀/∂h) from probes injected
into both packages, and the edit's finish under edit_deepcache_interval,
plain and with classifier-free guidance.

Gates: decoder bases σ rtol 1e-3 and |cos| ≥ 0.99 per direction, their Jᵀu
directions cos ≥ 0.999; DeepCache interval 1 bitwise equal to the plain
finish, interval 2 atol 1e-4 of the JAX driver's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread, sdxl_driver_pair  # noqa: F401

from diffusion_pullback_tpu.experiments import edit_sd as jedit_sd
from diffusion_pullback_tpu_torch.experiments import edit_sd as tedit_sd

GUIDANCE = 7.5
RANK = 2
CFG = dict(dataset_name="noise", for_steps=8, inv_steps=8, edit_t=0.6,
           edit_prompt="a test prompt", neg_prompt="ugly", for_prompt="a photo",
           pca_rank=RANK, pullback_min_iter=2, pullback_max_iter=2,
           pullback_atol=0.0, vis_num=2, vis_num_pc=1, pullback_attn_impl="xla")


@pytest.fixture(scope="module")
def drivers(tmp_path_factory):
    return sdxl_driver_pair(tmp_path_factory.mktemp("xl_dec"), CFG, size=8)


@pytest.fixture
def recorded(drivers, monkeypatch):
    """Both drivers at one injected z_t, their edit tails replaced by a
    recorder of the directions and names they are given."""
    jdrv, tdrv = drivers
    zt = np.random.default_rng(62).normal(size=(1, 8, 8, 4)).astype(np.float32)
    monkeypatch.setattr(jdrv, "run_DDIMinversion", lambda idx: jnp.asarray(zt))
    monkeypatch.setattr(jdrv, "DDIMforwardsteps", lambda z, start, end=None: z)
    monkeypatch.setattr(tdrv, "_zt", lambda idx: torch.from_numpy(zt))
    got = {}
    for key, drv in (("jax", jdrv), ("port", tdrv)):
        def record(z, vks, names, vis_num, _k=key):
            got[_k] = ([np.asarray(v).reshape(-1) for v in vks], list(names))
            return names
        monkeypatch.setattr(drv, "_edit_along_directions", record)
    return got


@pytest.mark.parametrize("x0", [False, True], ids=["eps", "x0"])
def test_decoder_edit_matches_jax(drivers, recorded, monkeypatch, x0):
    """run_edit_local_decoder_pullback_zt from the same probes in both
    packages: the decoder basis, then its h directions through the
    encoder's Jᵀ, named as the JAX driver names them."""
    jdrv, tdrv = drivers
    v_init = np.linalg.qr(np.random.default_rng(63).normal(
        size=(4 * 4 * 16, RANK)))[0].T.astype(np.float32)
    bases = {}
    for mod, name, cast, key, drv in (
            (jedit_sd, "local_pullback", jnp.asarray, "jax", jdrv),
            (tedit_sd, "local_decoder_pullback", torch.from_numpy, "port", tdrv)):
        monkeypatch.setattr(mod, name, lambda *a, _r=getattr(mod, name), _c=cast, **kw:
                            _r(*a, **{**kw, "v_init": _c(v_init)}))

        def basis(*a, _f=drv.compute_local_decoder_basis, _k=key, **kw):
            bases[_k] = _f(*a, **kw)
            return bases[_k]
        monkeypatch.setattr(drv, "compute_local_decoder_basis", basis)
    jdrv.run_edit_local_decoder_pullback_zt(0, pca_rank=RANK, x0_pullback=x0)
    tdrv.run_edit_local_decoder_pullback_zt(0, pca_rank=RANK, x0_pullback=x0)
    res, ref = bases["port"], bases["jax"]
    np.testing.assert_allclose(res.s.numpy(), np.asarray(ref.s), rtol=1e-3)
    cos = np.abs(np.sum(res.vT.numpy() * np.asarray(ref.vT), axis=1))
    assert cos.min() >= 0.99, cos
    (jv, jn), (tv, tn) = recorded["jax"], recorded["port"]
    assert tn == jn and len(tv) == 2
    for a, b in zip(tv, jv):
        assert np.dot(a, b) / np.linalg.norm(a) / np.linalg.norm(b) >= 0.999


@pytest.mark.parametrize("guidance", [0.0, GUIDANCE], ids=["plain", "cfg"])
def test_deepcache_finish(drivers, monkeypatch, guidance):
    """_finish_forward: at edit_deepcache_interval 1 bitwise the plain
    finish; at 2 (the pooled embeddings and time_ids of both CFG rows in
    the cache) within 1e-4 of the JAX driver's."""
    jdrv, tdrv = drivers
    rng = np.random.default_rng(64)
    sel = rng.normal(size=(3, 8, 8, 4)).astype(np.float32)
    for drv in (jdrv, tdrv):
        monkeypatch.setattr(drv.cfg, "guidance_scale", guidance)
    monkeypatch.setattr(tdrv.cfg, "edit_deepcache_interval", 1)
    plain = tdrv._finish_forward(torch.from_numpy(sel))
    assert torch.equal(plain, tdrv.DDIMforwardsteps(torch.from_numpy(sel),
                                                    tdrv.edit_t_idx))
    for drv in (jdrv, tdrv):
        monkeypatch.setattr(drv.cfg, "edit_deepcache_interval", 2)
    ref = jdrv._finish_forward(jdrv.unet_params, jnp.asarray(sel), jdrv.for_prompt_emb,
                               jdrv.neg_prompt_emb)
    out = tdrv._finish_forward(torch.from_numpy(sel))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    assert np.abs(out.numpy() - plain.numpy()).max() > 1e-4   # the cache was used
