"""The state-carrying SD U-Net of the port against the JAX package on the
CPU, f32, weights carried by load_flax_params: encode (intra-block taps
included), encode_with_state and decode_with_state at every tap,
forward_dh and shallow_encode; and the port's own identities
decode(encode(x)) = ε and forward_dh(0) = ε. Two tiny configs: the test
config (a cross-attention and a plain block) and one with two
cross-attention blocks of two layers, so that both inner kinds reach a
second layer. Tolerance rtol 1e-5 and atol 1e-5 of max(1, max |ref|): f32
roundoff grows with the features' scale, and the deepest taps reach
|h| ≈ 5 (single elements of the up blocks' outputs stray 1.5e-5–1.8e-5
at |h| ≈ 0.3–0.5). The JAX side runs eagerly: at these widths compiling
each tap's program costs more than running it."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import flax_params, nchw, nhwc, one_torch_thread  # noqa: F401

from diffusion_pullback_tpu.models import configs as jcfg
from diffusion_pullback_tpu.models.unet2d import TapPoint as JTap
from diffusion_pullback_tpu.models.unet2d_condition import UNet2DCondition as JUNet
from diffusion_pullback_tpu_torch.models import (
    CondTapState,
    TapPoint,
    UNet2DCondition,
    load_flax_params,
    sd_tiny_unet,
)

def close(out, ref, msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=1e-5 * max(1.0, float(np.abs(ref).max())),
                               err_msg=str(msg))
CROSS2 = dict(down_block_types=("cross", "cross"), up_block_types=("cross", "cross"),
              layers_per_block=2)
T = np.float32(437.0)


def _taps(cfg):
    """Every tap of a config: block outputs, mid, and each inner tap of
    each cross-attention down block."""
    taps = [("down", i) for i in range(len(cfg.down_block_types))] + [("mid", 0)]
    taps += [("up", i) for i in range(len(cfg.up_block_types))]
    inner = [("down", i, (kind, j)) for i, bt in enumerate(cfg.down_block_types)
             if bt == "cross" for kind in ("res", "attn")
             for j in range(cfg.layers_per_block)]
    return taps, inner


def _pair(over):
    jm = JUNet(dataclasses.replace(jcfg.sd_tiny_unet(8), **over))
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(size=(1, 8, 16)).astype(np.float32)
    params = flax_params(jm, jnp.asarray(x), jnp.float32(0.0), jnp.asarray(ctx))
    tm = load_flax_params(UNet2DCondition(dataclasses.replace(sd_tiny_unet(8), **over)),
                          params)
    tm.requires_grad_(False)
    return jm, params, tm, x, ctx


@pytest.fixture(scope="module", params=[{}, CROSS2], ids=["tiny", "cross2"])
def pairs(request):
    return _pair(request.param)


def _jax_encode_with_state(pair, tap):
    jm, params, _, x, ctx = pair
    return (lambda p, xx, c: jm.apply(p, xx, T, c, JTap(*tap),
                                             method=JUNet.encode_with_state)
                   )(params, jnp.asarray(x), jnp.asarray(ctx))


def _port_encode_with_state(pair, tap):
    _, _, tm, x, ctx = pair
    return tm.encode_with_state(nchw(x), torch.tensor(T), torch.from_numpy(ctx),
                                TapPoint(*tap))


def test_inner_tap_encode_matches_jax(pairs):
    """encode and encode_with_state honour TapPoint.inner: the activation
    after resnet j or self-attention j of the block, not the block output."""
    jm, params, tm, x, ctx = pairs
    for tap in _taps(tm.config)[1]:
        ref = (lambda p, xx, c, _t=tap: jm.apply(
            p, xx, T, c, JTap(*_t), method=JUNet.encode))(
            params, jnp.asarray(x), jnp.asarray(ctx))
        out = tm.encode(nchw(x), torch.tensor(T), torch.from_numpy(ctx), TapPoint(*tap))
        close(nhwc(out), np.asarray(ref), tap)
        h, state = _port_encode_with_state(pairs, tap)
        close(nhwc(h), np.asarray(ref), tap)
        assert state.skips == ()


def test_encode_with_state_matches_jax_at_every_tap(pairs):
    taps, inner = _taps(pairs[2].config)
    for tap in taps + inner:
        jh, jstate = _jax_encode_with_state(pairs, tap)
        h, state = _port_encode_with_state(pairs, tap)
        assert isinstance(state, CondTapState)
        close(nhwc(h), np.asarray(jh), tap)
        close(state.emb.numpy(), np.asarray(jstate.emb))
        np.testing.assert_allclose(state.context.numpy(), np.asarray(jstate.context))
        assert len(state.skips) == len(jstate.skips), tap
        for mine, theirs in zip(state.skips, jstate.skips):
            close(nhwc(mine), np.asarray(theirs), tap)


def test_decode_with_state_matches_jax_at_every_tap(pairs):
    """ε resumed from a perturbed h at every block tap, each package from
    its own state."""
    jm, params, tm, x, ctx = pairs
    rng = np.random.default_rng(12)
    for tap in _taps(tm.config)[0]:
        jh, jstate = _jax_encode_with_state(pairs, tap)
        dh = 0.1 * rng.normal(size=np.asarray(jh).shape).astype(np.float32)
        ref = (lambda p, hh, st, _t=tap: jm.apply(
            p, hh, st, JTap(*_t), method=JUNet.decode_with_state))(
            params, jh + dh, jstate)
        h, state = _port_encode_with_state(pairs, tap)
        out = tm.decode_with_state(h + nchw(dh), state, TapPoint(*tap))
        close(nhwc(out), np.asarray(ref), tap)


def test_decode_broadcasts_a_batch_one_state(pairs):
    """A batch-1 state (context included) fans out over a batch of h, as a
    probe batch meets the state of one sample."""
    jm, params, tm, x, ctx = pairs
    tap = ("mid", 0)
    jh, jstate = (lambda p, xx, c: jm.apply(
        p, xx, T, c, JTap(*tap), method=JUNet.encode_with_state))(
        params, jnp.asarray(x[:1]), jnp.asarray(ctx))
    hs = np.asarray(jh) * np.array([1.0, 0.5, -1.0], np.float32)[:, None, None, None]
    ref = (lambda p, hh, st: jm.apply(
        p, hh, st, JTap(*tap), method=JUNet.decode_with_state))(params, jnp.asarray(hs),
                                                               jstate)
    _, state = tm.encode_with_state(nchw(x[:1]), torch.tensor(T), torch.from_numpy(ctx),
                                    TapPoint(*tap))
    out = tm.decode_with_state(nchw(hs), state, TapPoint(*tap))
    close(nhwc(out), np.asarray(ref))


def test_decode_of_encode_and_zero_dh_are_eps(pairs):
    _, _, tm, x, ctx = pairs
    args = (nchw(x), torch.tensor(T), torch.from_numpy(ctx))
    eps = tm(*args)
    for tap in _taps(tm.config)[0]:
        h, state = tm.encode_with_state(*args, TapPoint(*tap))
        close(tm.decode_with_state(h, state, TapPoint(*tap)).numpy(), eps.numpy(), tap)
        close(tm.forward_dh(*args, torch.zeros_like(h), TapPoint(*tap)).numpy(),
              eps.numpy(), tap)


def test_forward_dh_matches_jax(pairs):
    jm, params, tm, x, ctx = pairs
    tap = ("up", 0)
    h, _ = _port_encode_with_state(pairs, tap)
    dh = 0.2 * np.random.default_rng(13).normal(size=nhwc(h).shape).astype(np.float32)
    ref = (lambda p, xx, c, d: jm.apply(p, xx, T, c, d, JTap(*tap),
                                               method=JUNet.forward_dh))(
        params, jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(dh))
    out = tm.forward_dh(nchw(x), torch.tensor(T), torch.from_numpy(ctx), nchw(dh),
                        TapPoint(*tap))
    close(nhwc(out), np.asarray(ref))


def test_shallow_encode_matches_jax_and_feeds_the_last_up_block(pairs):
    """shallow_encode returns the skips the last up block consumes, in
    order: decoding the ('up', n-2) activation from it gives ε."""
    jm, params, tm, x, ctx = pairs
    ref = (lambda p, xx, c: jm.apply(p, xx, T, c, method=JUNet.shallow_encode))(
        params, jnp.asarray(x), jnp.asarray(ctx))
    args = (nchw(x), torch.tensor(T), torch.from_numpy(ctx))
    state = tm.shallow_encode(*args)
    assert len(state.skips) == len(ref.skips) == tm.config.layers_per_block + 1
    close(state.emb.numpy(), np.asarray(ref.emb))
    for mine, theirs in zip(state.skips, ref.skips):
        close(nhwc(mine), np.asarray(theirs))
    tap = TapPoint("up", len(tm.up_blocks) - 2)
    h, _ = tm.encode_with_state(*args, tap)
    close(tm.decode_with_state(h, state, tap).numpy(), tm(*args).numpy())


def test_inner_taps_refuse_where_jax_does(pairs):
    _, _, tm, x, ctx = pairs
    args = (nchw(x), torch.tensor(T), torch.from_numpy(ctx))
    h, state = tm.encode_with_state(*args, TapPoint("down", 0, ("res", 0)))
    assert state.skips == ()
    with pytest.raises(NotImplementedError, match="intra-block"):
        tm.decode_with_state(h, state, TapPoint("down", 0, ("res", 0)))
    if tm.config.down_block_types[1] != "cross":
        with pytest.raises(ValueError, match="cross-attention block"):
            tm.encode(*args, TapPoint("down", 1, ("res", 0)))
    with pytest.raises(ValueError, match="only supported on down"):
        tm.encode(*args, TapPoint("mid", 0, ("res", 0)))
