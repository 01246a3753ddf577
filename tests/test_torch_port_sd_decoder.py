"""The decoder / x̂₀ pullback, the covector Jᵀu and the text-driven edit of
the port's SD driver against the JAX package's, on the CPU at f32 with the
weights carried by load_flax_params (tests/torch_port_common.py's
sd_driver_pair: the tiny U-Net at 32×32 latents, whose 1024-token
self-attention in the last up block reaches the fused pair from the mid
tap). Probes are injected (v_init) into both packages' local_pullback; the
edit tail is replaced by a recorder of the directions it is given.

Gates: pullback_covector within 1e-5 of max |Jᵀu| (f32 roundoff grows
with the scale: the tapped features reach |h| ≈ 10 here, see
tests/test_torch_port_sd_cfg_pullback.py); the decoder and x̂₀ bases σ rtol
1e-3 and |cos| ≥ 0.99 per direction; the Jᵀu directions of
_edit_with_global_h_basis and the text-driven direction cos ≥ 0.999; the
text-driven top-k coefficients rtol 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread, plain_shapes, sd_driver_pair  # noqa: F401

from diffusion_pullback_tpu.experiments import edit_sd as jedit_sd
from diffusion_pullback_tpu.geometry.pullback import pullback_covector as jcovector
from diffusion_pullback_tpu.models.unet2d import TapPoint as JTap
from diffusion_pullback_tpu_torch.experiments import edit_sd as tedit_sd
from diffusion_pullback_tpu_torch.geometry import pullback_covector
from diffusion_pullback_tpu_torch.models import TapPoint

RANK = 2
CFG = dict(dataset_name="noise", for_steps=8, inv_steps=8, edit_t=0.6,
           edit_prompt="a test prompt", pca_rank=RANK, pullback_min_iter=2,
           pullback_max_iter=2, pullback_atol=0.0, vis_num=2, vis_num_pc=RANK)


@pytest.fixture(scope="module")
def drivers(tmp_path_factory):
    """(JAX driver, port driver, z_t, t) with both drivers' inversion
    replaced by the same z_t."""
    jdrv, tdrv = sd_driver_pair(tmp_path_factory.mktemp("dec"), CFG)
    zt = np.random.default_rng(31).normal(size=(1, 32, 32, 4)).astype(np.float32)
    jdrv.run_DDIMinversion = lambda idx: jnp.asarray(zt)
    jdrv.DDIMforwardsteps = lambda z, start, end=None: z
    tdrv._zt = lambda idx: torch.from_numpy(zt)
    return jdrv, tdrv, zt, jdrv.fwd_grid.timesteps[jdrv.edit_t_idx]


@pytest.fixture
def recorded(drivers, monkeypatch):
    """The directions and names each driver hands its edit tail."""
    jdrv, tdrv, *_ = drivers
    got = {}
    for key, drv in (("jax", jdrv), ("port", tdrv)):
        def record(zt, vks, names, vis_num, _k=key):
            got[_k] = ([np.asarray(v).reshape(-1) for v in vks], list(names))
            return names
        monkeypatch.setattr(drv, "_edit_along_directions", record)
    return got


def _cos(a, b):
    return float(np.dot(a, b) / np.linalg.norm(a) / np.linalg.norm(b))


def _same_directions(got, tol=0.999):
    (jv, jn), (tv, tn) = got["jax"], got["port"]
    assert tn == jn and len(tv) == len(jv)
    for a, b, n in zip(tv, jv, tn):
        assert _cos(a, b) >= tol, (n, _cos(a, b))


def test_pullback_covector_matches_jax(drivers):
    jdrv, tdrv, zt, t = drivers
    tap = JTap("mid")
    jenc = lambda q: jdrv._tap_encode(jdrv.unet_params, q, t, jdrv.edit_prompt_emb, tap)
    u = np.random.default_rng(32).normal(size=jax.eval_shape(
        jenc, jnp.asarray(zt)).shape).astype(np.float32)
    ref = jax.jit(lambda z, uu: jcovector(jenc, z, uu))(jnp.asarray(zt), jnp.asarray(u))
    enc = tdrv._vjp_encoder(torch.tensor(float(t)), TapPoint("mid"), tdrv.edit_prompt_emb)
    v = pullback_covector(enc, torch.from_numpy(zt), torch.from_numpy(u).reshape(-1))
    assert v.shape == zt.shape
    bound = 1e-5 * np.abs(np.asarray(ref)).max()
    assert bound < 2e-4
    np.testing.assert_allclose(v.numpy(), np.asarray(ref), atol=bound)


@pytest.mark.parametrize("impl,x0", [("xla", False), ("xla", True), ("flash", False)])
def test_decoder_basis_matches_jax(drivers, monkeypatch, plain_shapes, impl, x0):
    """compute_local_decoder_basis (∂ε/∂h, or ∂ẑ₀/∂h) of each driver, from
    the same probes. On the pair the decode from the mid tap runs the last
    up block's two 1024-token self-attentions: K2–K5's plain versions at
    the primal B·H 2 and the probes' 2·2, twice per pass."""
    jdrv, tdrv, zt, t = drivers
    monkeypatch.setattr(jdrv.cfg, "pullback_attn_impl", impl)
    monkeypatch.setattr(tdrv.cfg, "pullback_attn_impl", impl)
    dim_h = 16 * 16 * 16
    v_init = np.linalg.qr(np.random.default_rng(33).normal(
        size=(dim_h, RANK)))[0].T.astype(np.float32)
    for mod, cast in ((jedit_sd, jnp.asarray), (tedit_sd, torch.from_numpy)):
        real = mod.local_decoder_pullback if mod is tedit_sd else mod.local_pullback
        monkeypatch.setattr(
            mod, "local_decoder_pullback" if mod is tedit_sd else "local_pullback",
            lambda *a, _r=real, _c=cast, **kw: _r(*a, v_init=_c(v_init), **kw))
    tap = JTap("mid")
    ref = jax.jit(lambda z: jdrv._decoder_pullback_impl(
        jdrv.unet_params, jdrv.edit_prompt_emb, z, t, tap, RANK, x0,
        jax.random.key(0)))(jnp.asarray(zt))
    res = tdrv.compute_local_decoder_basis(torch.from_numpy(zt), torch.tensor(float(t)),
                                           TapPoint("mid"), RANK, x0)
    assert res.iterations == int(ref.iterations) == 2
    np.testing.assert_allclose(res.s.numpy(), np.asarray(ref.s), rtol=1e-3)
    cos = np.abs(np.sum(res.vT.numpy() * np.asarray(ref.vT), axis=1))
    assert cos.min() >= 0.99, cos
    if impl == "flash":
        assert plain_shapes == {
            "flash_forward_plain": [],
            "flash_forward_lse_plain": [(2, 2, 1024)] * 8,
            "flash_tangent_plain": [(2, 4, 1024)] * 6,
            "flash_dq_plain": [(2, 4, 1024)] * 4,
            "flash_dkv_plain": [(2, 4, 1024)] * 4}


def test_h_basis_directions_match_jax(drivers, recorded):
    """_edit_with_global_h_basis: v = Jᵀu/‖Jᵀu‖ per column of an h basis,
    walked ±, as the decoder-pullback edits use it."""
    jdrv, tdrv, zt, t = drivers
    u = np.random.default_rng(34).normal(size=(16 * 16 * 16, RANK)).astype(np.float32)
    jdrv._edit_with_global_h_basis(0, jnp.asarray(u), "mid", 0, 2, RANK, "local_dec",
                                   zt=jnp.asarray(zt))
    tdrv._edit_with_global_h_basis(0, torch.from_numpy(u), "mid", 0, 2, RANK,
                                   "local_dec", zt=torch.from_numpy(zt))
    _same_directions(recorded)


def test_decoder_edit_runs_the_h_basis_through_the_encoder(drivers, recorded):
    """run_edit_local_decoder_pullback_zt hands the edit tail the decoder
    basis pulled back through Jᵀ, named as the JAX driver names them."""
    _, tdrv, zt, t = drivers
    for x0, tag in ((False, "local_dec"), (True, "local_dec_x0")):
        names = tdrv.run_edit_local_decoder_pullback_zt(0, pca_rank=RANK,
                                                        x0_pullback=x0)
        vks, got = recorded["port"]
        assert got == names and len(vks) == 2 * RANK
        assert all(n.startswith(f"Edit_{tag}-noise_0-edit_0.6T-mid-block_0-pc_")
                   for n in names)
        assert np.allclose([np.linalg.norm(v) for v in vks], 1.0, atol=1e-5)


def test_text_driven_direction_matches_jax(drivers, recorded):
    jdrv, tdrv, *_ = drivers
    jdrv.run_edit_text_driven_direction(0, num_pc=0)
    tdrv.run_edit_text_driven_direction(0, num_pc=0)
    _same_directions(recorded)


def test_text_driven_top_k_matches_jax(drivers, recorded, monkeypatch):
    """With num_pc = k the prompt's Δh is decomposed in the cached top-k
    basis (the JAX driver's, read by the port's cache): the coefficients,
    their order, signs and names, and the logged energy share."""
    jdrv, tdrv, zt, t = drivers
    name = jedit_sd.basis_name("noise", 0, 0.6, "mid", 0, 0,
                               edit_prompt="a test prompt", pca_rank=RANK)
    rng = np.random.default_rng(35)
    basis = (rng.normal(size=(16 * 16 * 16, RANK)).astype(np.float32),
             np.array([3.0, 2.0], np.float32),
             np.linalg.qr(rng.normal(size=(zt.size, RANK)))[0].T.astype(np.float32))
    jdrv.cache.save(name, *basis)
    tdrv.cache.save(name, *basis)
    jlogs, tlogs = [], []
    monkeypatch.setattr(jdrv.log, "log", lambda ev, **kw: jlogs.append((ev, kw)))
    monkeypatch.setattr(tdrv.log, "log", lambda ev, **kw: tlogs.append((ev, kw)))
    jdrv.run_edit_text_driven_direction(0, num_pc=RANK)
    tdrv.run_edit_text_driven_direction(0, num_pc=RANK)
    _same_directions(recorded)
    pick = lambda logs: next(kw for ev, kw in logs if ev == "text_driven_pc_decomposition")
    jkw, tkw = pick(jlogs), pick(tlogs)
    np.testing.assert_allclose(tkw["coefficients"], jkw["coefficients"], rtol=1e-3)
    assert abs(tkw["subspace_energy_fraction"] - jkw["subspace_energy_fraction"]) <= 1e-3
