"""The port's ADM family against the JAX package on the CPU, f32, weights
carried by load_flax_params from seeded numpy values (every weight nonzero,
the ones the JAX init zeroes included): UNetADM's ε (learned σ) for
adm_tiny(16) and its variants (plain conv sampling, additive embedding,
the DDPM time features, the new qkv order, class-conditional), the tapped h
at every tap, decode ∘ encode = ε, the inner-tap and missing-label errors;
EncoderUNetADM with its four pools; SuperResUNetADM; the full-width
layouts of ImageNet256Uncond and of the 256 px classifier on the meta
device against the JAX package's torch export of its jax.eval_shape tree;
model_for_name's thirteen ADM names; blockwise_attention and the 'auto'
dispatch; and the ADM-256 layout's self-attention calls per pass by token
count, which chip_smoke.py's launch counts assume.

Gates: ε, h and logits within 1e-5 of max(1, max |ref|)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import (  # noqa: F401
    flax_params,
    nchw,
    nhwc,
    one_torch_thread,
    plain_shapes,
)

from diffusion_pullback_tpu import models as jmodels
from diffusion_pullback_tpu.models import adm as jadm
from diffusion_pullback_tpu.models.convert import flax_params_to_torch_state_dict
from diffusion_pullback_tpu.ops import attention as jattn
from diffusion_pullback_tpu_torch import models as tmodels
from diffusion_pullback_tpu_torch.models import TapPoint
from diffusion_pullback_tpu_torch.ops import attention as tattn

T = 137.0
TAPS = [("down", 0), ("down", 1), ("mid", 0), ("up", 0), ("up", 1)]
VARIANTS = {
    "base": {},
    "conv-updown": dict(resblock_updown=False),
    "additive-emb": dict(use_scale_shift_norm=False),
    "ddpm-time": dict(time_embed_style="ddpm"),
    "new-order": dict(use_new_attention_order=True),
    "class-cond": dict(num_classes=5),
}


def _close(mine, ref, tol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(mine, ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()))


def _pair(over=None, size=16, seed=0):
    """(JAX UNetADM, its params, the port's UNetADM on them, x, y)."""
    over = over or {}
    jm = jadm.UNetADM(dataclasses.replace(jmodels.adm_tiny(size), **over))
    y = np.array([1, 3]) if over.get("num_classes") else None
    kw = {} if y is None else {"y": jnp.asarray(y)}
    params = flax_params(jm, jnp.zeros((2, size, size, 3)), jnp.float32(0.0), seed=seed,
                         **kw)
    tm = tmodels.load_flax_params(
        tmodels.UNetADM(dataclasses.replace(tmodels.adm_tiny(size), **over)), params)
    x = np.random.default_rng(seed + 1).normal(size=(2, size, size, 3)).astype(np.float32)
    return jm, params, tm, x, y


@pytest.fixture(scope="module")
def base():
    return _pair()


@pytest.mark.parametrize("variant", list(VARIANTS), ids=list(VARIANTS))
def test_eps_matches_jax(variant):
    jm, params, tm, x, y = _pair(VARIANTS[variant], seed=3)
    kw = {} if y is None else {"y": jnp.asarray(y)}
    ref = jm.apply(params, jnp.asarray(x), jnp.float32(T), **kw)
    with torch.no_grad():
        out = tm(nchw(x), T, y=None if y is None else torch.as_tensor(y))
    assert out.shape == (2, 6, 16, 16)   # ε and the σ half
    _close(nhwc(out), ref)


@pytest.mark.parametrize("tap", TAPS, ids=str)
def test_tapped_h_matches_jax(base, tap):
    jm, params, tm, x, _ = base
    ref = jm.apply(params, jnp.asarray(x), jnp.float32(T), jadm.TapPoint(*tap),
                   method=jadm.UNetADM.encode)
    with torch.no_grad():
        h = tm.encode(nchw(x), T, TapPoint(*tap))
    _close(nhwc(h), ref)


@pytest.mark.parametrize("tap", TAPS, ids=str)
def test_decode_of_encode_is_eps(base, tap):
    """decode_with_state ∘ encode_with_state is ε, also for an h batch of 2
    against a batch-1 state (the pullback's probes)."""
    _, _, tm, x, _ = base
    with torch.no_grad():
        eps = tm(nchw(x), T)
        h, state = tm.encode_with_state(nchw(x), T, TapPoint(*tap))
        torch.testing.assert_close(tm.decode_with_state(h, state, TapPoint(*tap)), eps,
                                   rtol=0, atol=0)
        h1, state1 = tm.encode_with_state(nchw(x[:1]), T, TapPoint(*tap))
        both = tm.decode_with_state(torch.cat([h1, h1]), state1, TapPoint(*tap))
    _close(both[1].numpy(), eps[0].numpy())   # batch 1 against batch 2: f32 roundoff


def test_inner_tap_and_missing_labels_raise():
    _, _, tm, x, _ = _pair()
    with pytest.raises(ValueError, match="intra-block taps"):
        tm.encode(nchw(x), T, TapPoint("down", 0, ("res", 0)))
    _, _, cond, x, _ = _pair(VARIANTS["class-cond"])
    with pytest.raises(ValueError, match="requires labels y"):
        cond(nchw(x), T)


@pytest.mark.parametrize("pool", ["adaptive", "attention", "spatial", "spatial_v2"])
def test_encoder_logits_match_jax(pool):
    jm = jadm.EncoderUNetADM(jmodels.adm_encoder_tiny(16, pool))
    params = flax_params(jm, jnp.zeros((2, 16, 16, 3)), jnp.float32(0.0), seed=4)
    tm = tmodels.load_flax_params(tmodels.EncoderUNetADM(tmodels.adm_encoder_tiny(16, pool)),
                                  params)
    x = np.random.default_rng(5).normal(size=(2, 16, 16, 3)).astype(np.float32)
    ref = jm.apply(params, jnp.asarray(x), jnp.float32(T))
    with torch.no_grad():
        out = tm(nchw(x), T)
    assert out.shape == (2, 10)
    _close(out.numpy(), ref)


def test_super_res_matches_jax():
    jm = jadm.SuperResUNetADM(jmodels.adm_tiny(16))
    params = flax_params(jm, jnp.zeros((2, 16, 16, 3)), jnp.float32(0.0), seed=6,
                         low_res=jnp.zeros((1, 8, 8, 3)))
    tm = tmodels.load_flax_params(tmodels.SuperResUNetADM(tmodels.adm_tiny(16)), params)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    low = rng.normal(size=(1, 8, 8, 3)).astype(np.float32)
    ref = jm.apply(params, jnp.asarray(x), jnp.float32(T), low_res=jnp.asarray(low))
    with torch.no_grad():
        out = tm(nchw(x), T, low_res=nchw(low))
        with pytest.raises(ValueError, match="low_res"):
            tm(nchw(x), T)
    _close(nhwc(out), ref)


def _jax_layout(module, *args):
    tree = jax.eval_shape(lambda k: module.init(k, *args), jax.random.key(0))
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), tree)
    return {k: tuple(v.shape) for k, v in flax_params_to_torch_state_dict(zeros).items()}


@pytest.mark.parametrize("which,n_params", [("ImageNet256Uncond", 552_814_086),
                                            ("classifier256", 54_096_360)])
def test_full_width_layout_matches_jax(which, n_params):
    x = jnp.zeros((1, 256, 256, 3))
    if which == "classifier256":
        theirs = _jax_layout(jadm.EncoderUNetADM(jmodels.adm_classifier(256)), x, 0.0)
        build = lambda: tmodels.EncoderUNetADM(tmodels.adm_classifier(256))
    else:
        theirs = _jax_layout(jadm.UNetADM(jmodels.adm_imagenet256_uncond()), x, 0.0)
        build = lambda: tmodels.model_for_name(which)
    with torch.device("meta"):
        mine = {k: tuple(v.shape) for k, v in build().state_dict().items()}
    assert mine == theirs
    assert sum(int(np.prod(s)) for s in mine.values()) == n_params


ADM_NAMES = ["LSUN_bedroom", "LSUN_cat", "LSUN_horse", "FFHQ_P2", "AFHQ_P2",
             "Flower_P2", "CIFAR10", "CIFAR10Uncond", "ImageNet64Uncond",
             "ImageNet256Uncond", "ImageNet256Cond", "ImageNet128Cond",
             "ImageNet64Cond"]


def test_model_for_name_routes_every_adm_name():
    for name in ADM_NAMES:
        ref = jmodels.model_for_name(name, attn_impl="flash").config
        with torch.device("meta"):
            m = tmodels.model_for_name(name, dtype="bfloat16", attn_impl="flash")
        assert isinstance(m, tmodels.UNetADM), name
        want = {f.name: getattr(ref, f.name) for f in dataclasses.fields(m.config)}
        assert dataclasses.asdict(m.config) == {**want, "dtype": "bfloat16"}, name
        assert m.out[2].weight.dtype == torch.bfloat16
    with torch.device("meta"):
        assert tmodels.model_for_name("FFHQ_P2").config.attn_impl == "xla"


@pytest.mark.parametrize("sk", [2048, 1536, 1031, 512],
                         ids=["two-blocks", "divisor-768", "prime-dense", "one-block"])
def test_blockwise_attention_matches_jax(sk):
    """Key blocks of 1024: 2048 splits in two; 1536 takes the largest
    divisor under 1024 (768); the prime 1031 has none above max(64, 128),
    so both take the dense path; 512 fits one block."""
    rng = np.random.default_rng(sk)
    q = rng.normal(size=(2, 64, 3, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, sk, 3, 16)).astype(np.float32) for _ in range(2))
    ref = jattn.blockwise_attention(*map(jnp.asarray, (q, k, v)))
    out = tattn.blockwise_attention(*map(torch.from_numpy, (q, k, v)))
    _close(out.numpy(), ref)
    _close(out.numpy(), tattn.xla_attention(*map(torch.from_numpy, (q, k, v))).numpy())


def test_auto_dispatch_and_blockwise_derivatives():
    """'auto' is the blockwise path from 1024 tokens on and the math path
    below; blockwise composes with torch.func (jvp and vjp as the math
    path's); 'ring' without a mesh falls back as 'auto' does.""" 
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(1, 2048, 2, 8)).astype(np.float32))
    f = lambda impl: (lambda y: tattn.attention(y, 0.5 * y, torch.tanh(y), impl=impl))
    torch.testing.assert_close(f("auto")(x), f("blockwise")(x), rtol=0, atol=0)
    small = x[:, :256]
    torch.testing.assert_close(f("auto")(small), f("xla")(small), rtol=0, atol=0)
    t = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    jb = torch.func.jvp(f("blockwise"), (x,), (t,))[1]
    jx = torch.func.jvp(f("xla"), (x,), (t,))[1]
    _close(jb.numpy(), jx.numpy())
    vb = torch.func.vjp(f("blockwise"), x)[1](t)[0]
    vx = torch.func.vjp(f("xla"), x)[1](t)[0]
    _close(vb.numpy(), vx.numpy())
    # 'ring' with no mesh published takes the dense path, the 'auto' rule
    for y in (x, small):
        torch.testing.assert_close(f("ring")(y), f("auto")(y), rtol=0, atol=0)


def test_adm256_self_attention_calls_per_pass(plain_shapes):
    """adm_imagenet256_uncond's layout (256 px, six levels, two res blocks,
    attention at 32², 16² and 8², heads of 64) at a narrow width (32
    channels, one head at 32²): with 'flash' a pass runs K1's plain version
    5 times at 1024 tokens (down level 3: 2, up: 3) and the encoder to the
    mid tap twice; the 256- and 64-token layers take the math path."""
    cfg = dataclasses.replace(tmodels.adm_imagenet256_uncond(), model_channels=32,
                              attn_impl="flash")
    m = tmodels.random_init_(tmodels.UNetADM(cfg), 0)
    x = torch.randn(1, 3, 256, 256, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        m(x, T)
        assert plain_shapes["flash_forward_plain"] == [(1, 1, 1024)] * 5
        m.encode(x, T, TapPoint("mid"))
    assert plain_shapes["flash_forward_plain"] == [(1, 1, 1024)] * 7
