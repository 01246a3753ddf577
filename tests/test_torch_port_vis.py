"""Parallel transport's geometry and the analysis artifacts of the port
against the JAX package on the CPU: transport_all / transport_direction on
seeded bases (f32, rtol 1e-6) and the JAX package's identity and
rotated-basis cases; radial_psd and visualize_vT_rgb's arrays equal to
the JAX ones on the same inputs (the arrays, not the PNG bytes); the PSD
curves of run_ddim_forward(vis_psd=True) against the JAX driver's from the
same x_T; the spectrum and direction map of a basis-cache miss written
into obs_folder with matplotlib present, and logged as vis_failed (the
run going on) when its import fails."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import ddpm_driver_pair, one_torch_thread, uncond_same_start  # noqa: F401

from diffusion_pullback_tpu.experiments import vis as jvis
from diffusion_pullback_tpu.geometry import transport as jtransport
from diffusion_pullback_tpu_torch.experiments import vis as tvis
from diffusion_pullback_tpu_torch.geometry import transport_all, transport_direction

CFG = dict(dataset_name="noise", for_steps=6, inv_steps=6, edit_t=0.6, pca_rank=2,
           pullback_min_iter=0, pullback_max_iter=1, x_space_guidance_num_step=2,
           vis_num=2, vis_num_pc=1, use_performance_boosting=False)


def _orth(rng, n, r):
    return np.linalg.qr(rng.normal(size=(n, r)))[0].astype(np.float32)


@pytest.mark.parametrize("dims", [(32, 24, 4), (300, 200, 50)])
def test_transport_matches_jax(dims):
    dim_h, dim_x, r = dims
    rng = np.random.default_rng(dim_h)
    u0, u1 = rng.normal(size=(2, dim_h, r)).astype(np.float32)
    vT1 = rng.normal(size=(r, dim_x)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (u0, u1, vT1)]
    j = [jnp.asarray(a) for a in (u0, u1, vT1)]
    np.testing.assert_allclose(transport_all(*t).numpy(),
                               np.asarray(jtransport.transport_all(*j)), rtol=1e-6, atol=1e-7)
    for k in (0, r - 1):
        np.testing.assert_allclose(transport_direction(*t, k).numpy(),
                                   np.asarray(jtransport.transport_direction(*j, k)),
                                   rtol=1e-6, atol=1e-7)


def test_transport_identity_and_rotated_basis():
    """Within one basis a direction stays; with u1 = u0·R the transported
    coefficients undo the rotation."""
    rng = np.random.default_rng(1)
    u = torch.from_numpy(_orth(rng, 32, 4))
    vT = torch.from_numpy(_orth(rng, 24, 4).T.copy())
    np.testing.assert_allclose(transport_direction(u, u, vT, 1).numpy(), vT[1].numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(transport_all(u, u, vT).numpy(), vT.numpy(), atol=1e-5)
    rng = np.random.default_rng(2)
    u0, rot = _orth(rng, 32, 3), _orth(rng, 3, 3)
    vT1 = _orth(rng, 24, 3).T.copy()
    expect = vT1.T @ (rot.T @ np.eye(3)[:, 0])
    v = transport_direction(*(torch.from_numpy(a) for a in (u0, u0 @ rot, vT1)), 0)
    np.testing.assert_allclose(v.numpy(), expect / np.linalg.norm(expect), atol=1e-5)


@pytest.mark.parametrize("shape,bins", [((16, 16, 3), 64), ((64, 48, 4), 16),
                                        ((31, 31), 64)])
def test_radial_psd_equals_jax(shape, bins):
    img = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    mine, theirs = tvis.radial_psd(img, bins), jvis.radial_psd(img, bins)
    assert mine.shape == theirs.shape
    np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("spatial", [(8, 8, 3), (4, 6, 4), (8, 8, 2)])
def test_visualize_vT_rgb_equals_jax(tmp_path, spatial):
    vT = np.random.default_rng(6).normal(size=(3, int(np.prod(spatial)))).astype(np.float32)
    mine = tvis.visualize_vT_rgb(vT, spatial, str(tmp_path / "port.png"))
    theirs = jvis.visualize_vT_rgb(vT, spatial, str(tmp_path / "jax.png"))
    assert mine.shape == (3, *spatial[:2], 3)
    np.testing.assert_array_equal(mine, theirs)
    assert (tmp_path / "port.png").exists()


def test_ddim_forward_psd_matches_jax(tmp_path, monkeypatch):
    """Two samples from the JAX driver's own x_T through the forward grid:
    xt_psd.png and et_psd.png in obs_folder, and each frame's curve (the
    first sample's) within 1e-3 of the JAX one."""
    jdrv, tdrv = ddpm_driver_pair(tmp_path, CFG)
    xT = np.array(jax.random.normal(jax.random.key(0), (2, 16, 16, 3), jnp.float32))
    monkeypatch.setattr(tdrv, "_draw_latents", lambda n, generator=None: torch.from_numpy(xT))
    curves = {}
    for key, mod in (("jax", jvis), ("port", tvis)):
        def record(traj, path, _r=mod.vis_power_spectral_density, _k=key, **kw):
            curves.setdefault(_k, []).append(_r(traj, path, **kw))
            return curves[_k][-1]
        monkeypatch.setattr(mod, "vis_power_spectral_density", record)
    os.makedirs(jdrv.cfg.obs_folder, exist_ok=True)
    jdrv.run_ddim_forward(num_samples=2, vis_psd=True)
    tdrv.run_ddim_forward(num_samples=2, vis_psd=True)
    assert sorted(os.listdir(tdrv.cfg.obs_folder)) == ["et_psd.png", "xt_psd.png"]
    for mine, theirs in zip(curves["port"], curves["jax"]):
        assert mine.shape == theirs.shape == (tdrv.fwd_grid.num_steps, 12)
        np.testing.assert_allclose(mine, theirs, rtol=1e-3)


def test_basis_cache_miss_writes_the_artifacts_or_logs_vis_failed(tmp_path, monkeypatch):
    """A computed basis leaves eigenvalue_spectrum-<name>.png and
    vT-<name>.png; with matplotlib unimportable the spectrum fails, the run
    logs vis_failed and still writes its edits."""
    jdrv, tdrv = ddpm_driver_pair(tmp_path, CFG)
    uncond_same_start(monkeypatch, jdrv, tdrv, rank=2)
    tdrv.run_edit_local_encoder_pullback_xt(idx=0)
    name = "local_basis-noise_0-0.6T-mid-block_0-seed_0-pca_rank_2"
    assert sorted(os.listdir(tdrv.cfg.obs_folder)) == [
        f"eigenvalue_spectrum-{name}.png", f"vT-{name}.png"]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    failed, log = [], tdrv.log.log
    monkeypatch.setattr(tdrv.log, "log", lambda e, **kw: (
        failed.append(kw) if e == "vis_failed" else None, log(e, **kw)))
    names = tdrv.run_edit_local_encoder_pullback_xt(idx=1)
    assert len(failed) == 1 and "matplotlib" in failed[0]["error"]
    assert all(os.path.exists(os.path.join(tdrv.cfg.result_folder, n + ".png"))
               for n in names)
    assert len(os.listdir(tdrv.cfg.obs_folder)) == 2
