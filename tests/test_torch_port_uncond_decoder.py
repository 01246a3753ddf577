"""The uncond decoder pullback of the port against the JAX package's on the
CPU at f32: ∂ε/∂h on ddpm_tiny(16) and on the 64 px UNetADM of
torch_port_common.ADM_TINY_1024 (the port's decode on the fused pair, whose
up level self-attends over 1024 tokens, so K2–K5's plain versions run;
the learned σ stays in ε, as in the JAX package), and ∂x̂₀/∂h on
ddpm_tiny. Both drivers get the same x_T per sample and the same probes
(drawn from the size of the map's input, so the decoder's h-space probes
too), and an edit tail replaced by a recorder. Gates: σ rtol 1e-3 and
|cos| ≥ 0.99 per σ-gap group for the basis, the edit directions |cos| ≥
0.99 with the JAX names. On a learned-σ net the x̂₀ variant raises in
both packages (ε has twice x_t's channels)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import (  # noqa: F401
    adm_driver_pair,
    ddpm_driver_pair,
    one_torch_thread,
    plain_shapes,
    record_edits,
    same_directions,
)

from diffusion_pullback_tpu.experiments import edit_uncond as jedit_uncond
from diffusion_pullback_tpu_torch.experiments import edit_uncond as tedit_uncond
from diffusion_pullback_tpu_torch.geometry import compare_bases, passes_acceptance
from diffusion_pullback_tpu_torch.models import TapPoint

CFG = dict(dataset_name="noise", for_steps=8, inv_steps=8, edit_t=0.6, pca_rank=2,
           pullback_min_iter=3, pullback_max_iter=3, pullback_atol=0.0, vis_num=2,
           vis_num_pc=2, x_space_guidance_num_step=2, use_performance_boosting=False)
RANK = 2


def same_start(monkeypatch, jdrv, tdrv, seed=70):
    """The same x_T for each sample idx (their inversions replaced) and the
    same orthonormal probes, drawn from the number of elements of the
    pulled-back map's input. Returns {'jax' | 'port': the driver's decoder
    pullback result}, filled as they run."""
    size = tdrv._sample_size
    shape = (1, size, size, tdrv.model.config.in_channels)
    xT = lambda idx: np.random.default_rng(seed + idx).normal(size=shape).astype(np.float32)
    monkeypatch.setattr(jdrv, "run_ddim_inversion", lambda idx: jnp.asarray(xT(idx)))
    monkeypatch.setattr(tdrv, "run_ddim_inversion", lambda idx: torch.from_numpy(xT(idx)))
    probes = lambda n: np.linalg.qr(np.random.default_rng(seed - 1).normal(
        size=(n, RANK)))[0].T.astype(np.float32)
    for mod, cast in ((jedit_uncond, jnp.asarray), (tedit_uncond, torch.from_numpy)):
        monkeypatch.setattr(mod, "local_pullback", lambda fn, x, *a, _r=mod.local_pullback,
                            _c=cast, **kw: _r(fn, x, *a, **{
                                **kw, "v_init": _c(probes(int(np.prod(x.shape))))}))
    results = {}
    for key, drv in (("jax", jdrv), ("port", tdrv)):
        def run(*a, _r=drv.compute_local_decoder_basis, _k=key, **kw):
            results[_k] = _r(*a, **kw)
            return results[_k]
        monkeypatch.setattr(drv, "compute_local_decoder_basis", run)
    return results


def _same_basis(results):
    host = lambda r: (np.asarray(r.vT, np.float64), np.asarray(r.s, np.float64))
    j, t = results["jax"], results["port"]
    cmp = compare_bases(*host(t), *host(j))
    assert passes_acceptance(cmp, cos_min=0.99, sigma_rtol=1e-3), cmp
    assert int(j.iterations) == t.iterations == 3


@pytest.mark.parametrize("kind,x0", [("ddpm", False), ("ddpm", True), ("adm", False)],
                         ids=["ddpm-eps", "ddpm-x0", "adm-eps-pair"])
def test_decoder_pullback_edit_matches_jax(tmp_path, monkeypatch, plain_shapes, kind, x0):
    pair = ddpm_driver_pair if kind == "ddpm" else adm_driver_pair
    jdrv, tdrv = pair(tmp_path, CFG)
    results = same_start(monkeypatch, jdrv, tdrv)
    got = record_edits(monkeypatch, jdrv, tdrv)
    jdrv.run_edit_local_decoder_pullback_zt(idx=1, pca_rank=RANK, x0_pullback=x0,
                                            edit_prompt="ignored")
    tdrv.run_edit_local_decoder_pullback_zt(idx=1, pca_rank=RANK, x0_pullback=x0,
                                            edit_prompt="ignored")
    _same_basis(results)
    same_directions(got, tol=0.99)
    tag = "local_dec_x0" if x0 else "local_dec"
    assert got["port"][1][0] == f"Edit_{tag}-noise_1-edit_0.6T-mid-block_0-pc_000_pos"
    if kind == "adm":
        # the decode from the mid tap: up level 1's self-attentions over 1024
        # tokens, one head of 64, on the pair (3 iterations and the final u)
        lse = plain_shapes["flash_forward_lse_plain"]
        assert lse and set(lse) == {(1, 1, 1024)}
        assert set(plain_shapes["flash_tangent_plain"]) == {(1, RANK, 1024)}
        assert set(plain_shapes["flash_dq_plain"]) >= {(1, RANK, 1024)}
        # the learned σ stays in the pulled-back ε: 6 channels per pixel
        assert results["port"].u.shape[0] == 64 * 64 * 6


def test_learned_sigma_x0_pullback_raises_in_both(tmp_path):
    """ε of a learned-σ net has 6 channels, x_t 3: the Tweedie map cannot
    broadcast them in the JAX package and the port refuses it by name."""
    jdrv, tdrv = adm_driver_pair(tmp_path, CFG)
    xt = np.random.default_rng(3).normal(size=(1, 64, 64, 3)).astype(np.float32)
    t = float(tdrv.fwd_grid.timesteps[tdrv.edit_t_idx])
    with pytest.raises(TypeError, match="incompatible shapes for broadcasting"):
        jdrv.compute_local_decoder_basis(jnp.asarray(xt), jnp.float32(t),
                                         jedit_uncond.TapPoint("mid", 0), RANK, True)
    with pytest.raises(ValueError, match="learned-sigma"):
        tdrv.compute_local_decoder_basis(torch.from_numpy(xt), torch.tensor(t),
                                         TapPoint("mid", 0), RANK, True)
