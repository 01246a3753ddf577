"""The port's drivers under a mesh (experiments/_common.py's mesh wiring,
the probe-sharded compute_local_basis, the dp harvests and prompt sweep,
tensor parallelism, rank 0 writing) against the JAX drivers under a mesh
of the 8-device CPU mesh (tests/conftest.py), mirroring the JAX package's
tests/test_mesh_wiring.py.

One launch of 4 gloo ranks (tests/torch_port_dist.py) runs every port
driver; the JAX drivers run here on the same weights (carried by
load_flax_params) and inputs: the same x_T (their inversions replaced;
the sample harvest inverts the same dataset images, as the JAX sweep does
inside its program) and the same probes injected into every pullback. σ
within rtol 1e-4 and vT within 1e-4 for the uncond drivers; 1e-3 for the
SD prompt sweep, as tests/test_mesh_wiring.py holds the JAX sweep to its
serial path. Every rank must return the same bases; only rank 0
writes the log, the PNGs and the basis files, and the other ranks read
the bases a sweep wrote after it."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import (  # noqa: F401
    ddpm_driver_pair,
    flax_params,
    one_torch_thread,
    sd_driver_pair,
    sd_tiny_arch,
)
from torch_port_dist import drivers_body, launch

from diffusion_pullback_tpu import experiments as jexp
from diffusion_pullback_tpu import models as jmodels
from diffusion_pullback_tpu.experiments import edit_sd as jedit_sd
from diffusion_pullback_tpu.experiments import edit_uncond as jedit
from diffusion_pullback_tpu.experiments import sd_harvest as jsd_harvest
from diffusion_pullback_tpu.ops import DiffusionSchedule as JSchedule
from diffusion_pullback_tpu.parallel import make_mesh as jax_mesh
from diffusion_pullback_tpu.parallel import sharded_pullback as jsharded
from diffusion_pullback_tpu.utils.datasets import NoiseDataset as JNoise
from diffusion_pullback_tpu.utils.logging import JSONLLogger as JLogger
from diffusion_pullback_tpu_torch import models as tmodels
from diffusion_pullback_tpu_torch.experiments.cache import load_basis

CFG = dict(for_steps=8, inv_steps=8, edit_t=0.6, pca_rank=8, pullback_min_iter=2,
           pullback_max_iter=4, pullback_atol=0.0, x_space_guidance_num_step=3,
           vis_num=2, vis_num_pc=1)
SD_CFG = dict(dataset_name="noise", for_steps=8, inv_steps=8, edit_t=0.6,
              edit_prompt="base", pca_rank=4, pullback_min_iter=2, pullback_max_iter=3,
              pullback_atol=0.0, x_space_guidance_num_step=2, vis_num=2, vis_num_pc=1)
GRID = (0.2, 0.4, 0.6, 0.8)
PROMPTS = ["p one", "p two", "p three"]
TAP = jmodels.TapPoint("mid", 0)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("drivers")
    jdrv, tdrv = ddpm_driver_pair(root / "pair", CFG)
    jsd, _ = sd_driver_pair(root / "sdpair", SD_CFG, size=8)
    rng = np.random.default_rng(3)
    # a two-head U-Net (head dim 8 of 16 channels at the mid block), so tp=2
    # splits its heads
    jcfg2 = dataclasses.replace(jmodels.ddpm_tiny(16), attention_head_dim=8)
    jm2 = jmodels.UNet2D(jcfg2)
    params2 = flax_params(jm2, jnp.zeros((1, 16, 16, 3)), jnp.float32(0.0), seed=5)
    cfg2 = dataclasses.replace(tmodels.ddpm_tiny(16), attention_head_dim=8)
    ucfg, tcfg = sd_tiny_arch(tmodels, 8)
    zT = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    data = dict(
        root=str(root / "mesh"), cfg=CFG, sd_cfg=SD_CFG, grid=GRID, prompts=PROMPTS,
        unet={k: v.numpy() for k, v in tdrv.model.state_dict().items()},
        unet2={k: v.numpy() for k, v in tmodels.load_flax_params(
            tmodels.UNet2D(cfg2), params2).state_dict().items()},
        cfg2=cfg2, xT=[rng.normal(size=(1, 16, 16, 3)).astype(np.float32) for _ in range(4)],
        v0=np.linalg.qr(rng.normal(size=(768, 8)))[0].T.astype(np.float32),
        sd=dict(ucfg=ucfg, tcfg=tcfg, unet=jsd.unet_params, vae=jsd.vae_params,
                text=jsd.text_params, zT=zT,
                v0=np.linalg.qr(rng.normal(size=(zT.size, 4)))[0].T.astype(np.float32)))
    ranks = launch(drivers_body, 4, tmp_path_factory.mktemp("rdzv"), data, timeout=240)
    jax_models = dict(unet=(jdrv.model, jdrv.params), unet2=(jm2, params2))
    return ranks, data, jax_models, jsd, root


def _folders(root, tag):
    return dict(result_folder=str(root / tag / "runs"), basis_folder=str(root / tag / "in"),
                obs_folder=str(root / tag / "obs"))


def jax_uncond(setup, monkeypatch, tag, mesh, model="unet", xT=True):
    """A JAX EditUncondDiffusion on ``mesh`` with the port drivers' weights,
    its pullbacks started from the same probes and, with ``xT``, its
    inversions replaced by the same x_T."""
    _, data, jax_models, _, root = setup
    jm, params = jax_models[model]
    drv = jexp.EditUncondDiffusion(
        jm, params, JSchedule.linear(), JNoise(16, n=4),
        jexp.UncondExperimentConfig(**CFG, **_folders(root, tag), mesh=mesh),
        logger=JLogger(path=None, echo=False))
    if xT:
        monkeypatch.setattr(drv, "run_ddim_inversion",
                            lambda idx: jnp.asarray(data["xT"][idx]))
    for mod in (jedit, jsharded):  # the driver's pullbacks, and the probe-sharded one's
        real = mod.local_pullback
        monkeypatch.setattr(mod, "local_pullback", lambda *a, _r=real, **kw: _r(
            *a, **{**kw, "v_init": jnp.asarray(data["v0"])}))
    return drv


def _same(a, b, s_rtol=1e-4, v_atol=1e-4):
    np.testing.assert_allclose(np.asarray(a[1]), np.asarray(b[1]), rtol=s_rtol)
    np.testing.assert_allclose(np.asarray(a[2]), np.asarray(b[2]), atol=v_atol)


def _basis_at_edit_t(drv):
    xt = drv.forward_to_edit_t(drv.run_ddim_inversion(0))
    return drv.compute_local_basis(xt, drv.fwd_grid.timesteps[drv.edit_t_idx], TAP, 8)


def test_probe_mesh_matches_the_jax_driver(setup, monkeypatch):
    ranks = setup[0]
    ref = _basis_at_edit_t(jax_uncond(setup, monkeypatch, "jprobe", jax_mesh(("probe",))))
    for r in ranks:
        assert r["probe_shards"] == 4
        _same((None, r["probe"].s, r["probe"].vT), (None, ref.s, ref.vT))


def test_only_rank_zero_writes(setup):
    ranks, data, _, _, _ = setup
    assert [r["writer_log"] for r in ranks] == [True, False, False, False]
    names = ranks[0]["edit"]
    assert all(r["edit"] == names for r in ranks)
    results = os.path.join(data["root"], "probe", "result")
    assert sorted(os.listdir(results)) == sorted(n + ".png" for n in names)
    with open(os.path.join(data["root"], "probe", "log.jsonl")) as f:
        events = [line for line in f if '"local_pullback"' in line]
    # the basis computed above and the edit's own (it was not cached)
    assert len(events) == 2 and all('"probe_shards": 4' in e for e in events)


def _dp4():
    return jax_mesh(("dp",), shape={"dp": 4}, devices=jax.devices()[:4])


def test_dp_tgrid_harvest_matches_jax(setup, monkeypatch):
    ranks = setup[0]
    ref = jax_uncond(setup, monkeypatch, "jgrid", _dp4())
    files = ref.run_sample_encoder_local_tangent_space_xt_batched(0, pca_rank=8,
                                                                  t_grid=GRID)
    for r in ranks:  # rank 0 wrote, every rank read them back
        for et in GRID:
            _same(r["grid"][et], load_basis(files[et]))


def test_dp_sample_harvest_matches_jax(setup, monkeypatch):
    ranks = setup[0]
    ref = jax_uncond(setup, monkeypatch, "jsamples", _dp4(), xT=False)
    ref = ref._harvest_bases([1, 2, 3], "mid", 0, pca_rank=8)
    for r in ranks:
        for i in (1, 2, 3):
            _same(r["samples"][i], ref[i])


def test_dp_probe_prompt_sweep_matches_jax(setup, monkeypatch):
    ranks, data, _, jsd, root = setup
    sd = data["sd"]
    drv = jexp.EditStableDiffusion(
        jsd.unet, jsd.unet_params, jsd.vae, jsd.vae_params, jsd.text_model,
        jsd.text_params, JSchedule.scaled_linear(), JNoise(16, n=1),
        jexp.SDExperimentConfig(**SD_CFG, **_folders(root, "jsd"),
                                mesh=jax_mesh(("dp", "probe"), shape={"dp": 2, "probe": 4})),
        logger=JLogger(path=None, echo=False))
    monkeypatch.setattr(drv, "run_DDIMinversion", lambda idx: jnp.asarray(sd["zT"]))
    for mod in (jedit_sd, jsd_harvest):
        real = mod.local_pullback
        monkeypatch.setattr(mod, "local_pullback", lambda *a, _r=real, **kw: _r(
            *a, **{**kw, "v_init": jnp.asarray(sd["v0"])}))
    ref = drv.run_sample_encoder_local_tangent_space_zt_various_prompt(
        PROMPTS, idx=0, pca_rank=4)
    for r in ranks:
        for p in PROMPTS:
            _same(r["prompts"][p], load_basis(ref[p]), s_rtol=1e-3, v_atol=1e-3)


def test_tp_mesh_matches_jax(setup, monkeypatch):
    ranks = setup[0]
    mesh = jax_mesh(("tp",), shape={"tp": 2}, devices=jax.devices()[:2])
    ref = _basis_at_edit_t(jax_uncond(setup, monkeypatch, "jtp", mesh, model="unet2"))
    for r in ranks:
        _same((None, r["tp"].s, r["tp"].vT), (None, ref.s, ref.vT))
