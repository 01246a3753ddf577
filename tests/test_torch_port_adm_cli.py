"""The port's uncond CLI on the ADM family, and its respacing and
classifier guidance, against the JAX package on the CPU: the flags
(--attn_impl, --pullback_attn_impl, --classifier_scale, --classifier_label,
--sampling_timesteps) reach the driver's config and model as the JAX CLI's
do, with the same folders; build_uncond builds UNetADM and the seed + 1
classifier; the CLI end to end with a tiny ADM in place of the 552 M one,
guided on the respaced grid; the OpenAI respacing grids and β tables;
classifier_grad_fn, condition_eps / condition_mean and guided_eps_fn; and
a guided forward on 'ddim10' through both drivers from one x_T.

Gates: exact grids; gradients and ε within 1e-5 of max(1, max |ref|);
latents along a trajectory 1e-4 of max(1, max |ref|)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import (  # noqa: F401
    adm_driver_pair,
    basis_ext,
    flax_params,
    one_torch_thread,
)

from diffusion_pullback_tpu import experiments as jexp
from diffusion_pullback_tpu import models as jmodels
from diffusion_pullback_tpu import samplers as jsamplers
from diffusion_pullback_tpu.ops import DiffusionSchedule as JSchedule
from diffusion_pullback_tpu.ops import schedule as jschedule
from diffusion_pullback_tpu.samplers import ddim_loop as jloop
from diffusion_pullback_tpu.utils.config import parse_args as jparse_args
from diffusion_pullback_tpu.utils.config import preset as jpreset
from diffusion_pullback_tpu_torch import experiments as texp
from diffusion_pullback_tpu_torch import main as tmain
from diffusion_pullback_tpu_torch import models as tmodels
from diffusion_pullback_tpu_torch.experiments._common import to_nchw, to_nhwc
from diffusion_pullback_tpu_torch.ops import schedule as tschedule
from diffusion_pullback_tpu_torch.ops.schedule import DiffusionSchedule
from diffusion_pullback_tpu_torch.samplers import ddim_loop as tloop
from diffusion_pullback_tpu_torch.samplers import guidance as tguidance

BOOST = ["--performance_boosting_t", "0.2"]


class _Built:
    """A driver stand-in that records what the builder gave it."""

    def __init__(self, *args, **kwargs):
        i = next(i for i, a in enumerate(args) if hasattr(a, "basis_folder"))
        self.model, self.cfg, self.dataset = args[0], args[i], args[i - 1]
        self.log_path = (kwargs.get("logger") or args[i + 1]).path
        self.cond_fn = None


class _Shape:
    def __init__(self, config=None):
        self.config = config

    def init(self, *args, **kwargs):
        return {}


def _stub(monkeypatch, calls):
    """Both builders run with stand-in drivers; JAX's models are shapes
    without parameters, the port's tiny (adm_tiny(16) and its classifier
    adm_encoder_tiny)."""
    def jmodel(name, **kw):
        calls["jax"] = kw
        return _Shape()

    def tmodel(name, dtype="float32", attn_impl=""):
        calls["port"] = dict(dtype=dtype, attn_impl=attn_impl)
        return tmodels.UNetADM(tmodels.adm_tiny(16))

    monkeypatch.setattr(jmodels, "model_for_name", jmodel)
    monkeypatch.setattr(jmodels, "EncoderUNetADM", _Shape)
    monkeypatch.setattr(tmodels, "model_for_name", tmodel)
    monkeypatch.setattr(tmodels, "adm_classifier", lambda size: tmodels.adm_encoder_tiny(size))
    for mod in (jexp, texp):
        monkeypatch.setattr(mod, "EditUncondDiffusion", _Built)


@pytest.mark.parametrize("model,flags", [
    ("ImageNet256Uncond", []),
    ("ImageNet256Uncond", ["--classifier_scale", "2.5", "--classifier_label", "7",
                           "--sampling_timesteps", "ddim25", "--pullback_attn_impl",
                           "blockwise"]),
    ("FFHQ_P2", ["--attn_impl", "blockwise", "--dataset_name", "CelebA_HQ"]),
], ids=["default", "guided-respaced", "ffhq-blockwise"])
def test_cli_flags_and_folders_match_jax(tmp_path, monkeypatch, model, flags):
    import main as jmain

    monkeypatch.chdir(tmp_path)
    calls = {}
    _stub(monkeypatch, calls)
    argv = ["--note", "n", "--model_name", model, "--result_folder",
            str(tmp_path / "runs"), "--device", "cpu"] + BOOST + flags
    jdrv = jmain.build_uncond(jpreset(jparse_args(argv)))
    tdrv = tmain.build_uncond(tmain.parse_args(argv))
    assert tdrv.cfg.basis_folder == jdrv.cfg.basis_folder
    assert tdrv.cfg.result_folder == jdrv.cfg.result_folder
    assert tdrv.log_path == jdrv.log_path
    for f in ("dataset_name", "for_steps", "edit_t", "pca_rank", "sampling_timesteps",
              "classifier_scale", "classifier_label", "pullback_attn_impl",
              "performance_boosting_t", "x_space_guidance_scale"):
        assert getattr(tdrv.cfg, f) == getattr(jdrv.cfg, f), f
    assert calls["port"] == {"dtype": calls["jax"]["dtype"],
                             "attn_impl": calls["jax"]["attn_impl"]}
    assert (tdrv.cond_fn is None) == (jdrv.cond_fn is None) == ("--classifier_scale"
                                                                not in flags)
    assert type(tdrv.dataset).__name__ == type(jdrv.dataset).__name__


def test_build_uncond_builds_adm_and_its_classifier(tmp_path, monkeypatch):
    """UNetADM from --model_name, the respaced grid, and a classifier drawn
    with seed + 1 whose gradient the driver folds into ε."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tmodels, "model_for_name", lambda name, dtype="float32",
                        attn_impl="": tmodels.UNetADM(tmodels.adm_tiny(16)))
    monkeypatch.setattr(tmodels, "adm_classifier",
                        lambda size: tmodels.adm_encoder_tiny(size))
    edit = tmain.build_uncond(tmain.parse_args(
        ["--note", "n", "--model_name", "ImageNet256Uncond", "--device", "cpu", "--seed",
         "4", "--classifier_scale", "3", "--classifier_label", "2",
         "--sampling_timesteps", "ddim10"] + BOOST))
    assert isinstance(edit.model, tmodels.UNetADM) and edit._sample_size == 16
    assert edit.fwd_grid.num_steps == 9 and float(edit.fwd_grid.timesteps[0]) == 900.0
    assert edit.dataset[0].shape == (1, 16, 16, 3)
    clf = tmodels.random_init_(tmodels.EncoderUNetADM(tmodels.adm_encoder_tiny(16)), 5)
    want = tguidance.classifier_grad_fn(lambda z, t: clf(to_nchw(z), t),
                                        torch.tensor([2]), scale=3.0)
    x = torch.randn(1, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        torch.testing.assert_close(edit.cond_fn(x, torch.tensor(500.0)),
                                   want(x, torch.tensor(500.0)), rtol=0, atol=0)
    assert edit._basis_name_extras() == "-clsg3.0-y2"


def test_adm_cli_runs_on_cpu(tmp_path, monkeypatch):
    """The CLI end to end at the preset's settings on a tiny ADM (learned σ),
    guided by the classifier on the 'ddim10' grid."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tmodels, "model_for_name", lambda name, dtype="float32",
                        attn_impl="": tmodels.UNetADM(tmodels.adm_tiny(16)))
    monkeypatch.setattr(tmodels, "adm_classifier",
                        lambda size: tmodels.adm_encoder_tiny(size))
    edit = tmain.main(["--note", "x", "--device", "cpu", "--model_name",
                       "ImageNet256Uncond", "--edit_t", "0.5",
                       "--x_space_guidance_num_step", "2", "--classifier_scale", "2",
                       "--sampling_timesteps", "ddim10",
                       "--run_edit_local_encoder_pullback_zt", "True",
                       "--run_ddim_forward", "True"] + BOOST)
    results = os.listdir(edit.cfg.result_folder)
    assert len([n for n in results if n.startswith("Edit_xt-noise_0")]) == 4
    assert "DDIMforward.png" in results
    basis = os.listdir(edit.cfg.basis_folder)
    assert basis == ["local_basis-noise_0-0.5T-mid-block_0-seed_0-pca_rank_2"
                     "-clsg2.0-y0" + basis_ext()]
    with open(edit.log.path) as f:
        events = [json.loads(line) for line in f]
    assert [e["encoder"] for e in events if e["event"] == "local_pullback"] == ["xla"]
    assert [e["finite"] for e in events if e["event"] == "finish_and_save"] == [True]


def test_adm_refusals(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.main(["--note", "x", "--model_name", "FFHQ_P2"] + BOOST)
    edit = texp.EditUncondDiffusion(
        tmodels.UNetADM(tmodels.adm_tiny(16)), DiffusionSchedule.linear(), None,
        texp.UncondExperimentConfig(basis_folder=str(tmp_path)), device="cpu")
    with pytest.raises(ValueError, match="intra-block taps"):
        edit._make_tap("mid", 0, after_res=True)
    # the regularizers are ported (SEGA among them), and so is the mesh: a
    # driver on a one-rank ('dp', 'probe') mesh keeps the weights and
    # shards no pullback
    assert texp.EditUncondDiffusion(
        tmodels.UNetADM(tmodels.adm_tiny(16)), DiffusionSchedule.linear(), None,
        texp.UncondExperimentConfig(use_sega_reg=True, basis_folder=str(tmp_path)),
        device="cpu").cfg.use_sega_reg
    from torch_port_dist import mesh, one_rank

    model = tmodels.UNetADM(tmodels.adm_tiny(16))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with one_rank(tmp_path):
        edit = texp.EditUncondDiffusion(
            model, DiffusionSchedule.linear(), None,
            texp.UncondExperimentConfig(mesh=mesh(("dp", "probe")),
                                        basis_folder=str(tmp_path)), device="cpu")
        assert edit._mesh_probe_size(2) == 0 and edit._harvest_dp(4, "skip") == 0
    for k, v in edit.model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


@pytest.mark.parametrize("spec", ["ddim25", "ddim50", "250", "25,25,25", "10"])
def test_respacing_matches_jax(spec):
    assert tschedule.space_timesteps(1000, spec) == jschedule.space_timesteps(1000, spec)
    for inversion in (False, True):
        mine = tschedule.respaced_timestep_grid(spec, inversion=inversion)
        theirs = jschedule.respaced_timestep_grid(spec, inversion=inversion)
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    steps = jschedule.space_timesteps(1000, spec)
    betas, tmap = tschedule.respaced_betas(DiffusionSchedule.linear(), steps)
    jbetas, jtmap = jschedule.respaced_betas(JSchedule.linear(), steps)
    assert tmap == jtmap == sorted(steps)
    np.testing.assert_allclose(betas, jbetas, rtol=1e-12)
    for bad in ("ddim999", "2000"):
        with pytest.raises(ValueError):
            tschedule.space_timesteps(1000, bad)


def test_classifier_guidance_matches_jax():
    """The classifier gradient (taken by torch.func.grad, under the
    samplers' no_grad too), condition_eps, guided_eps_fn and condition_mean
    on adm_encoder_tiny(16) and adm_tiny(16), shared weights."""
    jclf = jmodels.EncoderUNetADM(jmodels.adm_encoder_tiny(16))
    cp = flax_params(jclf, jnp.zeros((2, 16, 16, 3)), jnp.float32(0.0), seed=21)
    tclf = tmodels.load_flax_params(tmodels.EncoderUNetADM(tmodels.adm_encoder_tiny(16)), cp)
    jnet = jmodels.UNetADM(jmodels.adm_tiny(16))
    npar = flax_params(jnet, jnp.zeros((2, 16, 16, 3)), jnp.float32(0.0), seed=22)
    tnet = tmodels.load_flax_params(tmodels.UNetADM(tmodels.adm_tiny(16)), npar)
    rng = np.random.default_rng(23)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    y, t = np.array([4, 1]), 420.0
    jcond = jsamplers.classifier_grad_fn(lambda z, tt: jclf.apply(cp, z, tt),
                                         jnp.asarray(y), scale=2.0)
    tcond = tguidance.classifier_grad_fn(lambda z, tt: tclf(to_nchw(z), tt),
                                         torch.as_tensor(y), scale=2.0)
    jeps = lambda z, tt: jnet.apply(npar, z, tt)[..., :3]
    teps = lambda z, tt: to_nhwc(tnet(to_nchw(z), tt))[..., :3]
    ref_g = np.asarray(jax.jit(jcond)(jnp.asarray(x), jnp.float32(t)))
    ref_e = np.asarray(jax.jit(jsamplers.guided_eps_fn(jeps, jcond, JSchedule.linear()))(
        jnp.asarray(x), jnp.float32(t)))
    with torch.no_grad():
        g = tcond(torch.from_numpy(x), torch.tensor(t))
        e = tguidance.guided_eps_fn(teps, tcond, DiffusionSchedule.linear())(
            torch.from_numpy(x), torch.tensor(t))
    for mine, ref in ((g.numpy(), ref_g), (e.numpy(), ref_e)):
        np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()))
    assert np.abs(ref_g).max() > 1e-3
    abar = DiffusionSchedule.linear().alphas_cumprod[420]
    torch.testing.assert_close(
        tguidance.condition_eps(torch.ones(2), g[0, 0, 0, :2], abar),
        torch.ones(2) - torch.sqrt(1 - abar) * g[0, 0, 0, :2])
    np.testing.assert_allclose(
        tguidance.condition_mean(torch.from_numpy(x), 0.3, g).numpy(),
        np.asarray(jsamplers.condition_mean(jnp.asarray(x), 0.3, jnp.asarray(g.numpy()))),
        rtol=0, atol=1e-6)


def test_guided_ddim10_forward_matches_jax(tmp_path):
    """Classifier guidance on the respaced 'ddim10' grid (9 steps from 900,
    not 999) through both drivers' guided ε and ddim_forward from one x_T
    (adm_tiny(16)'s layout through adm_driver_pair, the classifier
    adm_encoder_tiny(16) on shared weights); the port's guided
    run_ddim_forward is finite and differs from the unguided one."""
    cfg = dict(for_steps=8, inv_steps=8, sampling_timesteps="ddim10")
    net = {f: getattr(tmodels.adm_tiny(16), f) for f in (
        "image_size", "model_channels", "num_res_blocks", "channel_mult",
        "attention_resolutions", "num_heads", "num_head_channels", "norm_num_groups")}
    jdrv, tdrv = adm_driver_pair(tmp_path, cfg, port_attn="xla", net=net)
    for drv in (jdrv, tdrv):
        assert drv.fwd_grid.num_steps == 9 and float(drv.fwd_grid.timesteps[0]) == 900.0
    clf = jmodels.EncoderUNetADM(jmodels.adm_encoder_tiny(16))
    cp = flax_params(clf, jnp.zeros((1, 16, 16, 3)), jnp.float32(0.0), seed=12)
    tclf = tmodels.load_flax_params(tmodels.EncoderUNetADM(tmodels.adm_encoder_tiny(16)), cp)
    jdrv.cond_fn = jsamplers.classifier_grad_fn(lambda z, t: clf.apply(cp, z, t),
                                                jnp.asarray([3]), scale=5.0)
    tdrv.cond_fn = tguidance.classifier_grad_fn(lambda z, t: tclf(to_nchw(z), t),
                                                torch.tensor([3]), scale=5.0)
    xT = np.random.default_rng(13).normal(size=(2, 16, 16, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda x: jloop.ddim_forward(
        jdrv.eps_fn, x, jdrv.schedule, jdrv.fwd_grid))(jnp.asarray(xT)))
    with torch.no_grad():
        out = tloop.ddim_forward(tdrv.eps_fn, torch.from_numpy(xT), tdrv.schedule,
                                 tdrv.fwd_grid).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * max(1.0, np.abs(ref).max()))
    guided = tdrv.run_ddim_forward(num_samples=2)
    tdrv.cond_fn = None
    plain = tdrv.run_ddim_forward(num_samples=2)
    assert guided.shape == plain.shape == (2, 16, 16, 3)
    assert torch.isfinite(guided).all()
    assert (guided - plain).abs().max() > 1e-3
