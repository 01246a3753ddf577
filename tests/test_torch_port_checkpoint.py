"""Checkpoint loading of the port against the JAX package's converter on
the CPU, with no checkpoint in the repository: state dicts written into
tmp_path from the port's flax_to_state_dict of tiny JAX-initialised models
(the names diffusers, transformers and guided-diffusion checkpoints
carry), with torch.save and with safetensors. The same file goes through
the JAX convert_torch_state_dict and through the port's loader, for the
DDPM and ADM U-Nets, the classifier, the SD and SDXL U-Nets, the VAE and
the two kinds of CLIP tower, and the outputs agree at f32 (1e-5 of
max(1, max |ref|)): ε, the logits, the VAE's decode and encoder mean, a
tower's hidden states, penultimate layer and pooled embedding. The old
diffusers attention names (on the DDPM net and the VAE), guided-diffusion's
1-D conv weights, a ``module.`` wrapper and a ``state_dict`` entry load;
buffers and EMA stems a module lacks are skipped; a missing, an extra or a
misshaped tensor raises. Then the port CLI's --checkpoint_path (an uncond
file, the SD family's diffusers folder) and --classifier_path on --device
cpu at tiny widths."""

import dataclasses
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import flax_params, nchw, nhwc, one_torch_thread  # noqa: F401

from diffusion_pullback_tpu import models as jmodels
from diffusion_pullback_tpu.models import convert as jconvert
from diffusion_pullback_tpu_torch import experiments as texp
from diffusion_pullback_tpu_torch import main as tmain
from diffusion_pullback_tpu_torch import models as tmodels
from diffusion_pullback_tpu_torch.models import convert as tconvert

BOOST = ["--performance_boosting_t", "0.2"]
IMG = (jnp.zeros((1, 16, 16, 3)), jnp.float32(0.0))
TOWER = dict(vocab_size=128, hidden_size=8, intermediate_size=16, max_length=8)


def _unet_cond(cfg):
    return (lambda: jmodels.UNet2DCondition(getattr(jmodels, cfg)(8)),
            lambda: tmodels.UNet2DCondition(getattr(tmodels, cfg)(8)),
            (jnp.zeros((1, 8, 8, 4)), jnp.float32(0.0), jnp.zeros((1, 8, 16))))


def _tower(act, projection):
    cfg = lambda m: dataclasses.replace(m.clip_text_tiny(), hidden_act=act, **TOWER)
    return (lambda: jmodels.CLIPTextModel(cfg(jmodels)),
            lambda: tmodels.CLIPTextModel(cfg(tmodels), projection=projection),
            (jnp.zeros((1, 8), jnp.int32),))


# (JAX module, port module, Flax init arguments) of each tiny net
NETS = {
    "ddpm": (lambda: jmodels.UNet2D(jmodels.ddpm_tiny(16)),
             lambda: tmodels.UNet2D(tmodels.ddpm_tiny(16)), IMG),
    "adm": (lambda: jmodels.UNetADM(jmodels.adm_tiny(16)),
            lambda: tmodels.UNetADM(tmodels.adm_tiny(16)), IMG),
    "classifier": (lambda: jmodels.EncoderUNetADM(jmodels.adm_encoder_tiny(16, pool="attention")),
                   lambda: tmodels.EncoderUNetADM(tmodels.adm_encoder_tiny(16, pool="attention")),
                   IMG),
    "sd_unet": _unet_cond("sd_tiny_unet"),
    "sdxl_unet": _unet_cond("sdxl_tiny_unet"),
    "vae": (lambda: jmodels.AutoencoderKL(jmodels.vae_tiny(16)),
            lambda: tmodels.AutoencoderKL(tmodels.vae_tiny(16)), IMG[:1]),
    "clip_L": _tower("quick_gelu", False),
    "clip_bigG": _tower("gelu", True),
}
INIT_KW = {"sdxl_unet": dict(added_cond=(jnp.zeros((1, 8)), jnp.zeros((1, 6)))),
           "clip_bigG": dict(return_pooled=True)}


def _net(kind, seed=3):
    jm, tm, args = NETS[kind]
    jm, tm = jm(), tm()
    return jm, flax_params(jm, *args, seed=seed, **INIT_KW.get(kind, {})), tm


def _outputs(kind, jm, params, tm):
    """(JAX outputs, port outputs) of ``kind`` on the same seeded inputs: ε
    or the logits at t = 420; the VAE's decode and encoder mean; a tower's
    hidden states, its penultimate layer and (with the projection) the
    pooled embedding."""
    rng = np.random.default_rng(4)
    normal = lambda *shape: rng.normal(size=shape).astype(np.float32)
    t, j, tt = 420.0, jnp.asarray, torch.from_numpy
    if kind in ("sd_unet", "sdxl_unet"):
        x, ctx = normal(2, 8, 8, 4), normal(2, 8, 16)
        added = (normal(2, 8), normal(2, 6)) if kind == "sdxl_unet" else None
        ref = [jm.apply(params, j(x), jnp.float32(t), j(ctx),
                        added_cond=added and tuple(map(j, added)))]
        out = [tm(nchw(x), torch.tensor(t), tt(ctx), added_cond=added and tuple(map(tt, added)))]
    elif kind == "vae":
        x, z = normal(2, 16, 16, 3), normal(2, 8, 8, 4)
        ref = [jm.apply(params, j(z), method=jm.decode),
               jm.apply(params, j(x), method=jm.encode_moments)[0]]
        out = [tm.decode(nchw(z)), tm.encode_moments(nchw(x))[0]]
    elif kind.startswith("clip"):
        ids = rng.integers(2, TOWER["vocab_size"], size=(2, 8))
        ids[:, 5] = 1                                               # the EOS token
        pooled = kind == "clip_bigG"
        ref = [*jm.apply(params, j(ids), return_pooled=True)] if pooled else [
            jm.apply(params, j(ids))]
        ref.append(jm.apply(params, j(ids), penultimate=True))
        out = [*tm(tt(ids), return_pooled=pooled)] if pooled else [tm(tt(ids))]
        out.append(tm(tt(ids), penultimate=True))
    else:
        x = normal(2, 16, 16, 3)
        ref = [jm.apply(params, j(x), jnp.float32(t))]
        out = [tm(nchw(x), torch.tensor(t))]
    return ([np.asarray(r) for r in ref],
            [nhwc(o) if o.ndim == 4 else o.numpy() for o in out])


def _old_names(sd):
    """diffusers' names before its 0.12 attention rewrite."""
    old = {".to_q.": ".query.", ".to_k.": ".key.", ".to_v.": ".value.",
           ".to_out.0.": ".proj_attn."}
    out = {}
    for k, v in sd.items():
        for new, o in old.items():
            k = k.replace(new, o)
        out[k] = v
    return out


def _conv1d(sd):
    """guided-diffusion's conv_nd(1, …) storage of the attention
    projections: (out, in) → (out, in, 1)."""
    return {k: (v[:, :, None] if k.rsplit(".", 2)[-2] in ("qkv", "proj_out", "qkv_proj",
                                                          "c_proj") and v.ndim == 2 else v)
            for k, v in sd.items()}


def _jax_clip_names(sd):
    """A transformers CLIP file's names as the JAX converter takes them:
    its flat tower has no text_model / embeddings / encoder / mlp scopes."""
    return {re.sub(r"^text_model\.(embeddings\.|encoder\.)?", "", k).replace(".mlp.", "."): v
            for k, v in sd.items()}


VARIANTS = {
    "plain": lambda sd: sd,
    "old_names": _old_names,
    "conv1d_wrapped": lambda sd: {"state_dict": {"module." + k: v
                                                 for k, v in _conv1d(sd).items()}},
    "with_buffers": lambda sd: {**sd, "model_ema.decay": torch.tensor(0.9999),
                                "mid_block.norm.num_batches_tracked": torch.tensor(3)},
}


def _write(sd, path):
    if path.endswith(".safetensors"):
        from safetensors.torch import save_file

        save_file({k: v.contiguous() for k, v in sd.items()}, path)
    else:
        torch.save(sd, path)


@pytest.mark.parametrize("kind,variant,ext", [
    ("ddpm", "plain", ".bin"), ("ddpm", "old_names", ".pt"), ("ddpm", "plain", ".safetensors"),
    ("adm", "conv1d_wrapped", ".pt"), ("adm", "with_buffers", ".ckpt"),
    ("classifier", "conv1d_wrapped", ".pt"), ("classifier", "plain", ".safetensors"),
    ("sd_unet", "plain", ".bin"), ("sdxl_unet", "plain", ".bin"),
    ("vae", "plain", ".bin"), ("vae", "old_names", ".bin"), ("vae", "plain", ".safetensors"),
    ("clip_L", "plain", ".bin"), ("clip_bigG", "plain", ".bin")])
def test_checkpoint_loads_in_both_packages(tmp_path, kind, variant, ext):
    """The file in a real checkpoint's names (diffusers, transformers,
    guided-diffusion) through the JAX converter and the port's loader: the
    outputs agree at f32. A CLIP file reaches the JAX converter under its
    flat names (_jax_clip_names); test_jax_converter_refuses_transformers_clip_names
    pins that it cannot take the transformers names as they are."""
    jm, params, tm = _net(kind)
    path = str(tmp_path / f"w{ext}")
    _write(VARIANTS[variant](tconvert.flax_to_state_dict(params, clip=kind.startswith("clip"))),
           path)
    sd = jconvert.load_torch_checkpoint_file(path)
    theirs = jconvert.convert_torch_state_dict(
        _jax_clip_names(sd) if kind.startswith("clip") else sd, params)
    tconvert.load_torch_checkpoint(path, tm)
    with torch.no_grad():
        refs, outs = _outputs(kind, jm, theirs, tm)
    for ref, out in zip(refs, outs, strict=True):
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("kind", ["clip_L", "clip_bigG"])
def test_jax_converter_refuses_transformers_clip_names(kind):
    """The JAX CLI hands a text tower's file to its converter as it is; a
    tower in transformers' names (text_model.…, mlp.fc1) does not load there
    (ROADMAP, "Expected divergences"), while the port loads it."""
    _, params, tm = _net(kind)
    sd = tconvert.flax_to_state_dict(params, clip=True)
    with pytest.raises(KeyError, match="checkpoint missing parameter"):
        jconvert.convert_torch_state_dict({k: v.numpy() for k, v in sd.items()}, params)
    tconvert.convert_torch_state_dict(sd, tm)


def test_loader_raises_on_missing_extra_or_misshaped(tmp_path):
    _, params, tm = _net("ddpm")
    sd = tconvert.flax_to_state_dict(params)
    cases = [
        ({k: v for k, v in sd.items() if k != "conv_in.weight"}, KeyError, "missing.*conv_in"),
        ({**sd, "surprise.weight": torch.zeros(3)}, KeyError, "unconsumed.*surprise"),
        ({**sd, "conv_in.weight": torch.zeros(9, 3, 3, 3)}, ValueError, "shape mismatch"),
    ]
    for bad, err, match in cases:
        with pytest.raises(err, match=match):
            tconvert.convert_torch_state_dict(bad, tm)
    with pytest.raises(err, match="shape mismatch"):
        jconvert.convert_torch_state_dict(
            {k: v.numpy() for k, v in cases[2][0].items()}, params)


def test_loader_casts_to_the_module_dtype_and_skips_clip_position_ids():
    """An f32 file into a bf16 module; a transformers CLIP tower's
    position_ids buffer, which the port's tower does not keep."""
    tm = tmodels.UNet2D(dataclasses.replace(tmodels.ddpm_tiny(8)))
    sd = {k: v.float() for k, v in tm.state_dict().items()}
    tm.to(torch.bfloat16)
    tconvert.convert_torch_state_dict(sd, tm)
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    text = tmodels.CLIPTextModel(tmodels.clip_text_tiny())
    sd = {**text.state_dict(), "text_model.embeddings.position_ids": torch.arange(77)[None]}
    tconvert.convert_torch_state_dict(sd, text)


def test_safetensors_absent_is_a_clear_error(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    with pytest.raises(RuntimeError, match="safetensors package"):
        tconvert.load_torch_checkpoint_file(str(tmp_path / "w.safetensors"))


def test_cli_loads_an_uncond_file_and_the_classifier(tmp_path, monkeypatch, capsys):
    """--checkpoint_path (guided-diffusion layout) and --classifier_path
    through build_uncond: the net's ε and the classifier's logits are the
    JAX models' on the files' weights; without the paths, seeded random
    init with the JAX CLI's notice."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tmodels, "model_for_name", lambda name, dtype="float32",
                        attn_impl="": tmodels.UNetADM(tmodels.adm_tiny(16)))
    monkeypatch.setattr(tmodels, "adm_classifier",
                        lambda size: tmodels.adm_encoder_tiny(size, pool="attention"))
    nets = {k: _net(k, seed) for k, seed in (("adm", 5), ("classifier", 6))}
    for kind, (_, params, _) in nets.items():
        torch.save(_conv1d(tconvert.flax_to_state_dict(params)), tmp_path / f"{kind}.pt")
    argv = ["--note", "n", "--model_name", "ImageNet256Uncond", "--device", "cpu",
            "--classifier_scale", "1"] + BOOST
    edit = tmain.build_uncond(tmain.parse_args(argv + [
        "--checkpoint_path", str(tmp_path / "adm.pt"),
        "--classifier_path", str(tmp_path / "classifier.pt")]))
    assert "no --checkpoint_path" not in capsys.readouterr().out
    x = np.random.default_rng(8).normal(size=(1, 16, 16, 3)).astype(np.float32)
    jm, params, _ = nets["adm"]
    ref = np.asarray(jm.apply(params, jnp.asarray(x), jnp.float32(300.0)))
    with torch.no_grad():
        out = nhwc(edit.model(nchw(x), torch.tensor(300.0)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()))
    # the classifier's gradient of log p(y=0 | x) is the JAX classifier's
    jc, cparams, tc = nets["classifier"]
    tconvert.convert_torch_state_dict(tconvert.flax_to_state_dict(cparams), tc)
    from diffusion_pullback_tpu_torch.samplers.guidance import classifier_grad_fn
    from diffusion_pullback_tpu_torch.experiments._common import to_nchw

    want = classifier_grad_fn(lambda z, t: tc(to_nchw(z), t), torch.tensor([0]))
    xt = torch.from_numpy(x)
    torch.testing.assert_close(edit.cond_fn(xt, torch.tensor(300.0)),
                               want(xt, torch.tensor(300.0)), rtol=0, atol=0)
    tmain.build_uncond(tmain.parse_args(argv))
    out = capsys.readouterr().out
    assert "[main] no --checkpoint_path: deterministic random init" in out
    assert "random-init classifier" in out


def _capture(*args, **kwargs):
    """An SD-family driver's models, in place of the driver."""
    i = next(i for i, a in enumerate(args) if hasattr(a, "basis_folder"))
    return args[:i - 2]


@pytest.mark.parametrize("family", ["sd", "sdxl"])
def test_cli_loads_a_diffusers_folder(tmp_path, monkeypatch, family):
    """The models a seed-7 build draws, saved where a diffusers folder keeps
    them (unet/diffusion_pytorch_model.bin, vae/…, text_encoder/… and for
    SDXL text_encoder_2/…), load back through --checkpoint_path into a
    build at another seed, tensor for tensor."""
    monkeypatch.chdir(tmp_path)
    tower = lambda: dataclasses.replace(tmodels.clip_text_tiny(), hidden_size=8)
    monkeypatch.setattr(tmodels, "sd21_base_unet", lambda **over: dataclasses.replace(
        tmodels.sd_tiny_unet(2), **over))
    monkeypatch.setattr(tmodels, "sdxl_base_unet", lambda **over: dataclasses.replace(
        tmodels.sdxl_tiny_unet(2), **over))
    monkeypatch.setattr(tmodels, "sd_vae", lambda **over: dataclasses.replace(
        tmodels.vae_tiny(16), **over))
    for name in ("sd21_text_encoder", "sdxl_text_encoder_1", "sdxl_text_encoder_2"):
        monkeypatch.setattr(tmodels, name, tower)
    monkeypatch.setattr(texp, "EditStableDiffusion", _capture)
    monkeypatch.setattr(texp, "EditStableDiffusionXL", _capture)
    build = tmain.build_sdxl if family == "sdxl" else tmain.build_sd
    model = (tmain.SDXL_MODEL if family == "sdxl" else tmain.SD_MODEL)
    argv = ["--note", "n", "--device", "cpu", "--model_name", model]
    drawn = build(tmain.parse_args(argv + ["--seed", "7"]))
    assert len(drawn) == (4 if family == "sdxl" else 3)
    for module, f in zip(drawn, tmain.SD_CHECKPOINT_FILES):
        os.makedirs(tmp_path / "ckpt" / os.path.dirname(f), exist_ok=True)
        torch.save(module.state_dict(), tmp_path / "ckpt" / f)
    loaded = build(tmain.parse_args(argv + ["--checkpoint_path", str(tmp_path / "ckpt")]))
    fresh = build(tmain.parse_args(argv))
    for a, b, c in zip(drawn, loaded, fresh):
        for (name, ta), tb, tc in zip(a.state_dict().items(), b.state_dict().values(),
                                      c.state_dict().values()):
            assert torch.equal(ta, tb), name
        assert any(not torch.equal(ta, tc) for ta, tc in zip(
            a.state_dict().values(), c.state_dict().values()))
