"""Shared helpers of the tests/test_torch_port_*.py files."""

import functools
import re

import jax
import numpy as np
import pytest
import torch


def flax_params(module, *example_args, seed=0, **init_kw):
    """A Flax param tree for ``module`` with seeded numpy values, built from
    the shapes alone (jax.eval_shape, no compile): LeCun-normal kernels and
    embeddings, norm scales 1 + 0.1·N(0,1), biases 0.1·N(0,1) — so every
    bias and scale is nonzero and its mapping into the port is exercised.
    ``init_kw`` go to init as they are (Python flags stay static)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(functools.partial(module.init, **init_kw),
                            jax.random.key(0), *example_args)

    def leaf(path, s):
        name = path[-1].key
        z = rng.normal(size=s.shape).astype(np.float32)
        if name == "kernel":
            return z * np.float32(np.prod(s.shape[:-1]) ** -0.5)
        if name == "embedding":
            return z * np.float32(s.shape[-1] ** -0.5)
        if name == "scale":
            return 1.0 + 0.1 * z
        return 0.1 * z

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).detach().numpy()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for a test module's small tensors: the tier-1 run
    puts six test processes on the CPU's cores, and torch's per-op thread
    team, spinning at every tiny op, slows all of them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def basis_ext() -> str:
    """The extension the port's BasisCache writes here: .dpb through the
    native library when it builds, else .npz."""
    from diffusion_pullback_tpu_torch.utils import native

    return ".dpb" if native.get_lib() is not None else ".npz"


PLAIN = ("flash_forward_plain", "flash_forward_lse_plain", "flash_tangent_plain",
         "flash_dq_plain", "flash_dkv_plain")


@pytest.fixture
def plain_shapes(monkeypatch):
    """The calls of the kernels' plain versions (the CPU side of K1–K5):
    name → [(primal B·H, tangents' or cotangent's B·H, S), ...]."""
    from diffusion_pullback_tpu_torch.ops import flash_attention as tfa

    calls = {name: [] for name in PLAIN}
    for name in PLAIN:
        real = getattr(tfa, name)

        def spy(q, k, v, *rest, _n=name, _f=real, **kw):
            batched = rest[0] if _n in ("flash_tangent_plain", "flash_dq_plain",
                                        "flash_dkv_plain") else q
            calls[_n].append((q.shape[0], batched.shape[0], q.shape[1]))
            return _f(q, k, v, *rest, **kw)

        monkeypatch.setattr(tfa, name, spy)
    return calls


def sd_tiny_arch(m, size: int):
    """(U-Net config, text-tower config) of sd_driver_pair's tiny SD models,
    from either package's models module ``m``."""
    import dataclasses

    return m.sd_tiny_unet(size), dataclasses.replace(m.clip_text_tiny(), hidden_size=16)


def sd15_tiny_arch(m, size: int):
    """A tiny SD 1.5-shaped pair of configs from either package's models
    module ``m``: sd15_unet's 1×1-conv projections, per-block head counts
    and dims that differ (2 heads of 8 at 16 channels in the first block,
    4 of 12 at 48 in the mid block), one cross block down and up around a
    plain one, and a 16-wide quick-GELU tower read at its final LayerNorm."""
    import dataclasses

    unet = dataclasses.replace(
        m.sd15_unet(), sample_size=size, block_out_channels=(16, 48),
        down_block_types=("cross", "down"), up_block_types=("up", "cross"),
        layers_per_block=1, attention_heads=(2, 4), attention_head_dim=(8, 12),
        transformer_depth=(1, 1), cross_attention_dim=16, norm_num_groups=4)
    text = dataclasses.replace(m.sd15_text_encoder(), vocab_size=128, hidden_size=16,
                               intermediate_size=32, num_layers=2, num_heads=2,
                               max_length=8, eos_token_id=1)
    return unet, text


def sd_driver_pair(root, cfg: dict, size: int = 32, arch=sd_tiny_arch):
    """(JAX EditStableDiffusion, the port's) on shared f32 weights, carried
    by load_flax_params: the tiny U-Net and text tower of ``arch`` (default
    sd_tiny_arch: the tiny SD U-Net, a 16-wide tower) with the U-Net at
    ``size``² latents (at 32 its first block self-attends over 1024 tokens
    and so reaches the fused kernels), a tiny VAE at 2·``size`` px, the
    scaled-linear schedule, seeded noise images, ``cfg`` as both drivers'
    SDExperimentConfig fields, and folders under ``root``."""
    import jax.numpy as jnp

    from diffusion_pullback_tpu import experiments as jexp
    from diffusion_pullback_tpu import models as jmodels
    from diffusion_pullback_tpu.ops import DiffusionSchedule as JSchedule
    from diffusion_pullback_tpu.utils.datasets import NoiseDataset as JNoise
    from diffusion_pullback_tpu.utils.logging import JSONLLogger as JLogger
    from diffusion_pullback_tpu_torch import experiments as texp
    from diffusion_pullback_tpu_torch import models as tmodels
    from diffusion_pullback_tpu_torch.ops.schedule import DiffusionSchedule
    from diffusion_pullback_tpu_torch.utils.datasets import NoiseDataset
    from diffusion_pullback_tpu_torch.utils.logging import JSONLLogger

    px = 2 * size
    ucfg, tcfg = arch(jmodels, size)
    unet = jmodels.UNet2DCondition(ucfg)
    vae = jmodels.AutoencoderKL(jmodels.vae_tiny(px))
    text = jmodels.CLIPTextModel(tcfg)
    up = flax_params(unet, jnp.zeros((1, size, size, 4)), jnp.float32(0.0),
                     jnp.zeros((1, tcfg.max_length, tcfg.hidden_size)), seed=0)
    vp = flax_params(vae, jnp.zeros((1, px, px, 3)), seed=1)
    tp = flax_params(text, jnp.zeros((1, tcfg.max_length), jnp.int32), seed=2)
    folders = lambda tag: dict(result_folder=str(root / tag / "runs"),
                               basis_folder=str(root / tag / "in"),
                               obs_folder=str(root / tag / "obs"))
    jdrv = jexp.EditStableDiffusion(
        unet, up, vae, vp, text, tp, JSchedule.scaled_linear(), JNoise(px, n=1),
        jexp.SDExperimentConfig(**cfg, **folders("jax")),
        logger=JLogger(path=None, echo=False))
    load = tmodels.load_flax_params
    tucfg, ttcfg = arch(tmodels, size)
    tdrv = texp.EditStableDiffusion(
        load(tmodels.UNet2DCondition(tucfg), up),
        load(tmodels.AutoencoderKL(tmodels.vae_tiny(px)), vp),
        load(tmodels.CLIPTextModel(ttcfg), tp),
        DiffusionSchedule.scaled_linear(), NoiseDataset(px, n=1),
        texp.SDExperimentConfig(**cfg, **folders("port")),
        logger=JSONLLogger(path=None, echo=False), device="cpu")
    return jdrv, tdrv


def sdxl_driver_pair(root, cfg: dict, size: int = 64):
    """(JAX EditStableDiffusionXL, the port's) on shared f32 weights, as
    sd_driver_pair: sdxl_tiny_unet at ``size``² latents (at 64 its
    cross-attention level self-attends over 1024 tokens and so reaches the
    fused kernels), the tiny VAE at 2·``size`` px with SDXL's scaling factor,
    two 8-wide towers (the first with quick_gelu, the second with the pooled
    projection), whose contexts concatenate to the U-Net's 16."""
    import dataclasses

    import jax.numpy as jnp

    from diffusion_pullback_tpu import experiments as jexp
    from diffusion_pullback_tpu import models as jmodels
    from diffusion_pullback_tpu.ops import DiffusionSchedule as JSchedule
    from diffusion_pullback_tpu.utils.datasets import NoiseDataset as JNoise
    from diffusion_pullback_tpu.utils.logging import JSONLLogger as JLogger
    from diffusion_pullback_tpu_torch import experiments as texp
    from diffusion_pullback_tpu_torch import models as tmodels
    from diffusion_pullback_tpu_torch.ops.schedule import DiffusionSchedule
    from diffusion_pullback_tpu_torch.utils.datasets import NoiseDataset
    from diffusion_pullback_tpu_torch.utils.logging import JSONLLogger

    px = 2 * size
    towers = [dict(hidden_size=8, intermediate_size=16, hidden_act=act)
              for act in ("quick_gelu", "gelu")]
    unet = jmodels.UNet2DCondition(jmodels.sdxl_tiny_unet(size))
    vae = jmodels.AutoencoderKL(dataclasses.replace(jmodels.vae_tiny(px),
                                                    scaling_factor=0.13025))
    texts = [jmodels.CLIPTextModel(dataclasses.replace(jmodels.clip_text_tiny(), **t))
             for t in towers]
    n = texts[0].config.max_length
    up = flax_params(unet, jnp.zeros((1, size, size, 4)), jnp.float32(0.0),
                     jnp.zeros((1, n, 16)), seed=0,
                     added_cond=(jnp.zeros((1, 8)), jnp.zeros((1, 6))))
    vp = flax_params(vae, jnp.zeros((1, px, px, 3)), seed=1)
    tps = [flax_params(t, jnp.zeros((1, n), jnp.int32), seed=2 + i, return_pooled=i == 1)
           for i, t in enumerate(texts)]
    folders = lambda tag: dict(result_folder=str(root / tag / "runs"),
                               basis_folder=str(root / tag / "in"),
                               obs_folder=str(root / tag / "obs"))
    jdrv = jexp.EditStableDiffusionXL(
        unet, up, vae, vp, texts[0], tps[0], texts[1], tps[1],
        JSchedule.scaled_linear(), JNoise(px, n=1),
        jexp.SDExperimentConfig(**cfg, **folders("jax")),
        logger=JLogger(path=None, echo=False))
    load = tmodels.load_flax_params
    tdrv = texp.EditStableDiffusionXL(
        load(tmodels.UNet2DCondition(tmodels.sdxl_tiny_unet(size)), up),
        load(tmodels.AutoencoderKL(dataclasses.replace(tmodels.vae_tiny(px),
                                                       scaling_factor=0.13025)), vp),
        *(load(tmodels.CLIPTextModel(dataclasses.replace(tmodels.clip_text_tiny(), **t),
                                     projection=i == 1), tp)
          for i, (t, tp) in enumerate(zip(towers, tps))),
        DiffusionSchedule.scaled_linear(), NoiseDataset(px, n=1),
        texp.SDExperimentConfig(**cfg, **folders("port")),
        logger=JSONLLogger(path=None, echo=False), device="cpu")
    return jdrv, tdrv


ADM_TINY_1024 = dict(image_size=64, model_channels=32, channel_mult=(1, 2),
                     num_res_blocks=1, attention_resolutions=(2,),
                     num_head_channels=64, norm_num_groups=8)


def adm_driver_pair(root, cfg: dict, jax_attn: str = "xla", port_attn: str = "flash",
                    net: dict = ADM_TINY_1024):
    """(JAX EditUncondDiffusion, the port's) on a tiny UNetADM with shared
    f32 weights, carried by load_flax_params: by default ADM_TINY_1024, 64
    px, two levels, attention at 32² (1024 tokens, one head of 64, so the
    port's 'flash' reaches the kernels' plain versions) and in the mid
    block, learned σ; ``net`` gives other ADMConfig fields. Seeded noise
    images, the linear schedule, ``cfg`` as both drivers' config fields,
    folders under ``root``. The models sample with ``jax_attn`` /
    ``port_attn``."""
    import jax.numpy as jnp

    from diffusion_pullback_tpu import experiments as jexp
    from diffusion_pullback_tpu import models as jmodels
    from diffusion_pullback_tpu.ops import DiffusionSchedule as JSchedule
    from diffusion_pullback_tpu.utils.datasets import NoiseDataset as JNoise
    from diffusion_pullback_tpu.utils.logging import JSONLLogger as JLogger
    from diffusion_pullback_tpu_torch import experiments as texp
    from diffusion_pullback_tpu_torch import models as tmodels
    from diffusion_pullback_tpu_torch.ops.schedule import DiffusionSchedule
    from diffusion_pullback_tpu_torch.utils.datasets import NoiseDataset
    from diffusion_pullback_tpu_torch.utils.logging import JSONLLogger

    px = net["image_size"]
    jm = jmodels.UNetADM(jmodels.ADMConfig(**net, attn_impl=jax_attn))
    params = flax_params(jm, jnp.zeros((1, px, px, 3)), jnp.float32(0.0), seed=9)
    tm = tmodels.load_flax_params(
        tmodels.UNetADM(tmodels.ADMConfig(**net, attn_impl=port_attn)), params)
    folders = lambda tag: dict(result_folder=str(root / tag / "runs"),
                               basis_folder=str(root / tag / "in"),
                               obs_folder=str(root / tag / "obs"))
    jdrv = jexp.EditUncondDiffusion(
        jm, params, JSchedule.linear(), JNoise(px, n=1),
        jexp.UncondExperimentConfig(**cfg, **folders("jax")),
        logger=JLogger(path=None, echo=False))
    tdrv = texp.EditUncondDiffusion(
        tm, DiffusionSchedule.linear(), NoiseDataset(px, n=1),
        texp.UncondExperimentConfig(**cfg, **folders("port")),
        logger=JSONLLogger(path=None, echo=False), device="cpu")
    return jdrv, tdrv


def sd_same_start(monkeypatch, jdrv, tdrv, zT: np.ndarray, rank: int, seed: int = 41):
    """Hand an SD-family driver pair the same z_T (their inversions
    replaced) and the same orthonormal probes (v_init into every pullback
    either driver runs: the JAX compute_local_basis and fused sweeps, the
    port's local_encoder_pullback)."""
    import jax.numpy as jnp

    from diffusion_pullback_tpu.experiments import edit_sd as jedit_sd
    from diffusion_pullback_tpu.experiments import sd_harvest as jsd_harvest
    from diffusion_pullback_tpu_torch.experiments import edit_sd as tedit_sd

    v_init = np.linalg.qr(np.random.default_rng(seed).normal(
        size=(zT.size, rank)))[0].T.astype(np.float32)
    monkeypatch.setattr(jdrv, "run_DDIMinversion", lambda idx: jnp.asarray(zT))
    monkeypatch.setattr(tdrv, "run_DDIMinversion", lambda idx: torch.from_numpy(zT))
    for mod, name, cast in ((jedit_sd, "local_pullback", jnp.asarray),
                            (jsd_harvest, "local_pullback", jnp.asarray),
                            (tedit_sd, "local_encoder_pullback", torch.from_numpy)):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _c=cast, **kw: _r(
            *a, **{**kw, "v_init": _c(v_init)}))


def basis_stem(path: str) -> str:
    """A basis file's name without folder and extension (.npz or .dpb)."""
    import os

    return os.path.splitext(os.path.basename(path))[0]


def same_basis_files(a: str, b: str, cos_min: float = 0.99, sigma_rtol: float = 1e-3):
    """Two basis files (either package's .dpb or .npz)
    within σ rtol ``sigma_rtol`` and cosine ≥ ``cos_min`` per σ-gap group."""
    import os

    from diffusion_pullback_tpu_torch.experiments.cache import BasisCache
    from diffusion_pullback_tpu_torch.geometry import compare_bases, passes_acceptance

    (_, s_a, vT_a), (_, s_b, vT_b) = (
        BasisCache(os.path.dirname(p)).load(basis_stem(p)) for p in (a, b))
    cmp = compare_bases(vT_a, s_a, vT_b, s_b)
    assert passes_acceptance(cmp, cos_min=cos_min, sigma_rtol=sigma_rtol), cmp


def ddpm_driver_pair(root, cfg: dict, size: int = 16):
    """(JAX EditUncondDiffusion, the port's) on ddpm_tiny(``size``) with
    shared f32 weights carried by load_flax_params, four seeded noise
    images, the linear schedule, ``cfg`` as both drivers' config fields,
    folders under ``root``."""
    import jax.numpy as jnp

    from diffusion_pullback_tpu import experiments as jexp
    from diffusion_pullback_tpu import models as jmodels
    from diffusion_pullback_tpu.ops import DiffusionSchedule as JSchedule
    from diffusion_pullback_tpu.utils.datasets import NoiseDataset as JNoise
    from diffusion_pullback_tpu.utils.logging import JSONLLogger as JLogger
    from diffusion_pullback_tpu_torch import experiments as texp
    from diffusion_pullback_tpu_torch import models as tmodels
    from diffusion_pullback_tpu_torch.ops.schedule import DiffusionSchedule
    from diffusion_pullback_tpu_torch.utils.datasets import NoiseDataset
    from diffusion_pullback_tpu_torch.utils.logging import JSONLLogger

    jm = jmodels.UNet2D(jmodels.ddpm_tiny(size))
    params = flax_params(jm, jnp.zeros((1, size, size, 3)), jnp.float32(0.0), seed=6)
    tm = tmodels.load_flax_params(tmodels.UNet2D(tmodels.ddpm_tiny(size)), params)
    folders = lambda tag: dict(result_folder=str(root / tag / "runs"),
                               basis_folder=str(root / tag / "in"),
                               obs_folder=str(root / tag / "obs"))
    jdrv = jexp.EditUncondDiffusion(
        jm, params, JSchedule.linear(), JNoise(size, n=4),
        jexp.UncondExperimentConfig(**cfg, **folders("jax")),
        logger=JLogger(path=None, echo=False))
    tdrv = texp.EditUncondDiffusion(
        tm, DiffusionSchedule.linear(), NoiseDataset(size, n=4),
        texp.UncondExperimentConfig(**cfg, **folders("port")),
        logger=JSONLLogger(path=None, echo=False), device="cpu")
    return jdrv, tdrv


def uncond_same_start(monkeypatch, jdrv, tdrv, rank: int, seed: int = 60):
    """Hand an uncond driver pair the same x_T for each sample idx (drawn
    from seed + idx; their inversions replaced) and the same orthonormal
    probes (v_init into every pullback either driver runs). Returns the
    x_T of an idx as a numpy array."""
    import jax.numpy as jnp

    from diffusion_pullback_tpu.experiments import edit_uncond as jedit_uncond
    from diffusion_pullback_tpu_torch.experiments import edit_uncond as tedit_uncond

    size = tdrv._sample_size
    shape = (1, size, size, tdrv.model.config.in_channels)
    xT = lambda idx: np.random.default_rng(seed + idx).normal(size=shape).astype(np.float32)
    monkeypatch.setattr(jdrv, "run_ddim_inversion", lambda idx: jnp.asarray(xT(idx)))
    monkeypatch.setattr(tdrv, "run_ddim_inversion", lambda idx: torch.from_numpy(xT(idx)))
    v_init = np.linalg.qr(np.random.default_rng(seed - 1).normal(
        size=(int(np.prod(shape)), rank)))[0].T.astype(np.float32)
    for mod, cast in ((jedit_uncond, jnp.asarray), (tedit_uncond, torch.from_numpy)):
        real = mod.local_pullback
        monkeypatch.setattr(mod, "local_pullback", lambda *a, _r=real, _c=cast, **kw: _r(
            *a, **{**kw, "v_init": _c(v_init)}))
    return xT


def record_edits(monkeypatch, jdrv, tdrv):
    """{'jax' | 'port': (directions flattened, names)} of what each
    driver hands its edit tail, which is replaced by the recorder."""
    got = {}
    for key, drv in (("jax", jdrv), ("port", tdrv)):
        def record(zt, vks, names, vis_num, _k=key):
            got[_k] = ([np.asarray(v, np.float64).reshape(-1) for v in vks], list(names))
            return names
        monkeypatch.setattr(drv, "_edit_along_directions", record)
    return got


def same_directions(got, tol: float = 0.999):
    """record_edits' two records: the same names, each direction within
    |cos| ≥ tol of the JAX one. A principal or mean direction is defined
    up to its sign (the two packages' solvers may pick either), and each
    is walked both ways, so a flip only swaps a ± pair."""
    (jv, jn), (tv, tn) = got["jax"], got["port"]
    assert tn == jn and len(tv) == len(jv) > 0
    for a, b, n in zip(tv, jv, tn):
        cos = float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))
        assert abs(cos) >= tol, (n, cos)


def inject_jax_draws(monkeypatch, module, rank: int, seed: int = 0, oversample: int = 8):
    """Make ``module``'s local_pca take the JAX local_pca's own draws for
    every chunk i (δ from fold_in(key, i), Ω from
    fold_in(fold_in(key, 0x0FF5E7), i), key = jax.random.key(seed))
    through its ``draw`` argument."""
    import jax
    import jax.numpy as jnp

    real = module.local_pca
    key = jax.random.key(seed)

    def with_jax_draws(fn, x, _seed, **kw):
        chunk = kw["chunk"]

        def draw(i):
            delta = jax.random.normal(jax.random.fold_in(key, i),
                                      (chunk,) + tuple(x.shape[1:]), jnp.float32)
            omega = jax.random.normal(
                jax.random.fold_in(jax.random.fold_in(key, 0x0FF5E7), i),
                (chunk, rank + oversample), jnp.float32)
            return torch.from_numpy(np.array(delta)), torch.from_numpy(np.array(omega))
        return real(fn, x, _seed, draw=draw, **kw)

    monkeypatch.setattr(module, "local_pca", with_jax_draws)


def copy_bases(jdrv, tdrv):
    """Copy the JAX driver's basis files into the port driver's folder."""
    import os
    import shutil

    os.makedirs(tdrv.cfg.basis_folder, exist_ok=True)
    for f in os.listdir(jdrv.cfg.basis_folder):
        shutil.copy(os.path.join(jdrv.cfg.basis_folder, f), tdrv.cfg.basis_folder)


def same_pngs(jdrv, tdrv, names, size: int, frames: int = 3):
    """Each named PNG of the two drivers' result folders: ``frames``
    images of ``size`` px side by side, within one uint8 level."""
    import os

    from PIL import Image

    for n in names:
        a, b = (np.asarray(Image.open(os.path.join(d.cfg.result_folder, n + ".png")),
                           np.int16) for d in (tdrv, jdrv))
        assert a.shape == b.shape == (size, frames * size, 3)
        assert np.abs(a - b).max() <= 1, n


# every post-edit regularizer of the walk frames on, q off its default
REGULARIZERS = dict(use_dynamic_thresholding=True, dynamic_thresholding_q=0.7,
                    use_preserve_contrast=True, use_preserve_norm=True)


def spy_regularize(monkeypatch, tdrv):
    """The frames and walk start of each of a port driver's _regularize
    calls, and its output."""
    seen, real = [], tdrv._regularize

    def spy(sel, z_start):
        out = real(sel, z_start)
        seen.append((sel, z_start, out))
        return out
    monkeypatch.setattr(tdrv, "_regularize", spy)
    return seen


def norms_kept(seen):
    """One _regularize call, preserve_norm last: every frame at the walk
    start's norm, and the frames moved."""
    (sel, z_start, out), = seen
    flat = out.reshape(out.shape[0], -1)
    np.testing.assert_allclose(torch.linalg.norm(flat, dim=1).numpy(),
                               float(torch.linalg.norm(z_start)), rtol=1e-5)
    assert (out - sel).abs().max() > 1e-4   # the regularizers moved the frames


def _diffusers_name(name: str, clip: bool) -> str:
    """The JAX package's torch export name → diffusers / transformers: the
    samplers keep their inner ``conv``, attention outputs are ``to_out.0``,
    a CLIP tower sits under ``text_model`` (embeddings, encoder.layers.i
    with its MLP under ``mlp``) except its ``text_projection``."""
    name = re.sub(r"(downsamplers|upsamplers)\.0\.(weight|bias)$", r"\1.0.conv.\2", name)
    name = re.sub(r"to_out\.(weight|bias)$", r"to_out.0.\1", name)
    if not clip or name.startswith("text_projection"):
        return name
    name = re.sub(r"\.(fc[12])\.", r".mlp.\1.", name)
    if name.startswith("layers."):
        return "text_model.encoder." + name
    if name.startswith(("token_embedding", "position_embedding")):
        return "text_model.embeddings." + name
    return "text_model." + name


def jax_layout(module, clip, *args, **kw):
    """{diffusers name: shape} of the JAX module's torch export, from its
    jax.eval_shape tree with zero-stride numpy leaves (no array is
    allocated)."""
    from diffusion_pullback_tpu.models.convert import flax_params_to_torch_state_dict

    tree = jax.eval_shape(lambda k: module.init(k, *args, **kw), jax.random.key(0))
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape),
                         tree)
    return {_diffusers_name(k, clip): tuple(v.shape)
            for k, v in flax_params_to_torch_state_dict(zeros).items()}


def port_layout(build):
    """{name: shape} of the port module ``build()`` makes on the meta
    device."""
    with torch.device("meta"):
        m = build()
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}
