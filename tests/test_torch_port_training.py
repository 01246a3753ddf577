"""The port's train step and checkpoints against the JAX package on the CPU,
on the same weights (carried by load_flax_params), batch and draws (the
JAX step's own t, weights and noise, through the port step's ``draw``).

adm_tiny(16) with zero_init=False in f32: one step with SGD, with AdamW,
with the hybrid objective and loss-aware sampling, and with accum_steps=2
against JAX's; the loss, the gradients (the JAX step's, captured by an
optax stage ahead of the optimizer) and grad_norm within 1e-5 relative;
the params and both EMA copies within 1e-6 after SGD; after AdamW within
1e-6 where |g| > 1e-3·max|g| and within 2·lr elsewhere (Adam's first step
is lr·sign(g) wherever |g| ≫ ε, so two right implementations part by 2·lr
where g is rounding noise). The ValueErrors of a mismatched EMA tuple and
of a batch that accum_steps does not divide, which leave the state as it
was. One step on ADM_TINY_1024 with attn 'flash': the port's K2/K4/K5
plain versions against JAX's Pallas kernels in interpret mode, within
1e-4. A bf16 step keeps f32 params, EMA and optimizer state, and its loss
is within 2e-2 of the f32 step's. CheckpointManager: the round trip, keep
and the tuple EMA (as tests/test_parallel.py's checkpoint tests), no
folder left by a save that raises, and one more step from a state and from
its restored copy bit for bit."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_common import (  # noqa: F401
    ADM_TINY_1024,
    flax_params,
    nchw,
    one_torch_thread,
    plain_shapes,
)

from diffusion_pullback_tpu import models as jmodels
from diffusion_pullback_tpu import training as jtrain
from diffusion_pullback_tpu.ops import DiffusionSchedule as JSchedule
from diffusion_pullback_tpu_torch import models as tmodels
from diffusion_pullback_tpu_torch import training as ttrain
from diffusion_pullback_tpu_torch.models.convert import flax_to_state_dict
from diffusion_pullback_tpu_torch.ops.schedule import DiffusionSchedule
from diffusion_pullback_tpu_torch.training import checkpoint as tckpt
from diffusion_pullback_tpu_torch.training.checkpoint import CheckpointManager

SIZE, BATCH, T = 16, 4, 1000
LR = {"sgd": 1e-2, "adamw": 1e-3}


def _torch_opt(name):
    if name == "sgd":
        return functools.partial(torch.optim.SGD, lr=LR["sgd"])
    return functools.partial(torch.optim.AdamW, lr=LR["adamw"], weight_decay=1e-2)


def _jax_opt(name):
    return (optax.sgd(LR["sgd"]) if name == "sgd"
            else optax.adamw(LR["adamw"], weight_decay=1e-2))


@pytest.fixture(scope="module")
def tiny():
    """(JAX UNetADM, its params, the port's UNetADM on them, the batch
    NHWC) for adm_tiny(16) with zero_init=False, learned σ."""
    over = dict(zero_init=False)
    jm = jmodels.UNetADM(dataclasses.replace(jmodels.adm_tiny(SIZE), **over))
    params = flax_params(jm, jnp.zeros((1, SIZE, SIZE, 3)), jnp.float32(0.0), seed=21)
    tm = tmodels.load_flax_params(
        tmodels.UNetADM(dataclasses.replace(tmodels.adm_tiny(SIZE), **over)), params)
    x = 0.5 * np.random.default_rng(22).normal(size=(BATCH, SIZE, SIZE, 3))
    return jm, params, tm, x.astype(np.float32)


def jax_draws(key, x, accum_steps=1, sampler=None):
    """The JAX step's draws of each microbatch, as torch (t, weights, noise
    NCHW): split(key, accum_steps) then split(key_i) into (kt, kn), or
    split(key) at accum_steps 1."""
    keys = [key] if accum_steps == 1 else jax.random.split(key, accum_steps)
    mb = x.shape[0] // accum_steps
    out = []
    for key_i in keys:
        kt, kn = jax.random.split(key_i)
        if sampler is None:
            t, w = jtrain.uniform_sample_t(kt, mb, T)
        else:
            t, w = jtrain.loss_aware_sample_t(sampler, kt, mb)
        noise = jax.random.normal(kn, (mb,) + x.shape[1:], jnp.float32)
        out.append((torch.tensor(np.asarray(t)).long(), torch.tensor(np.asarray(w)),
                    nchw(np.asarray(noise))))
    return out


def run_jax(tiny, opt, key, n_ema=2, ema_rate=(0.5, 0.9), sampler=None, **kw):
    """One jitted JAX step: (new state, metrics, the gradients it applied,
    which an optax stage ahead of ``opt`` keeps as its state[, sampler
    state])."""
    jm, params, _, x = tiny
    keep = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (g, g))
    tx = optax.chain(keep, opt)
    state = jtrain.create_train_state(params, tx, n_ema=n_ema)
    step = jtrain.make_train_step(lambda p, xt, t: jm.apply(p, xt, t), JSchedule.linear(),
                                  tx, ema_rate=ema_rate, loss_aware=sampler is not None,
                                  **kw)
    out = jax.jit(step)(state, jnp.asarray(x), key,
                        *(() if sampler is None else (sampler,)))
    return (*out[:2], out[0].opt_state[0], *out[2:])


def run_port(tiny, opt, draws, n_ema=2, ema_rate=(0.5, 0.9), model=None, sampler=None,
             **kw):
    """One port step from the same weights with the given draws (loss-aware
    with a ``sampler`` state): (state before, new state, metrics, the
    gradients it applied[, sampler state])."""
    _, _, tm, x = tiny
    model = model or tm
    state = ttrain.create_train_state(tm.state_dict(), opt, n_ema=n_ema)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    step = ttrain.make_train_step(model, DiffusionSchedule.linear(), opt,
                                  ema_rate=ema_rate, loss_aware=sampler is not None, **kw)
    out = step(state, nchw(x), sampler_state=sampler, draw=lambda i: draws[i])
    grads = {k: v.grad for k, v in out[0].params.items()}
    return before, out[0], out[1], grads, *out[2:]


def close_trees(mine, ref_tree, atol):
    ref = flax_to_state_dict(ref_tree)
    assert set(mine) == set(ref)
    for k, v in mine.items():
        np.testing.assert_allclose(v.detach().numpy(), ref[k].numpy(), rtol=0, atol=atol,
                                   err_msg=k)


def close_grads(mine, ref_tree, tol=1e-5):
    ref = flax_to_state_dict(ref_tree)
    scale = max(float(v.abs().max()) for v in ref.values())
    close_trees(mine, ref_tree, tol * scale)
    return ref


def close_metrics(metrics, ref, tol=1e-5):
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[name]), float(ref[name]), rtol=tol,
                                   err_msg=name)
    assert metrics["step"] == int(ref["step"]) == 1


VARIANTS = {
    "sgd": dict(opt="sgd"),
    "adamw": dict(opt="adamw"),
    "accum2": dict(opt="sgd", accum_steps=2),
    "hybrid-loss-aware": dict(opt="sgd", learn_sigma_vb_weight=0.001, loss_aware=True),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_step_matches_jax(tiny, variant):
    kw = dict(VARIANTS[variant])
    opt, loss_aware = kw.pop("opt"), kw.pop("loss_aware", False)
    key = jax.random.key(23)
    jsampler = tsampler = None
    if loss_aware:  # a warmed-up sampler, so the importance weights are not 1
        rng = np.random.default_rng(24)
        jsampler, tsampler = jtrain.init_loss_aware(T, 2), ttrain.init_loss_aware(T, 2)
        for _ in range(2):
            losses = rng.uniform(0.1, 2.0, size=T).astype(np.float32)
            jsampler = jtrain.update_loss_aware(jsampler, jnp.arange(T), jnp.asarray(losses))
            tsampler = ttrain.update_loss_aware(tsampler, torch.arange(T),
                                                torch.from_numpy(losses))
    jout = run_jax(tiny, _jax_opt(opt), key, sampler=jsampler, **kw)
    draws = jax_draws(key, tiny[3], kw.get("accum_steps", 1), jsampler)
    if loss_aware:
        assert not all(bool((w == 1).all()) for _, w, _ in draws)
    before, state, metrics, grads, *sampler = run_port(tiny, _torch_opt(opt), draws,
                                                       sampler=tsampler, **kw)

    close_metrics(metrics, jout[1])
    ref_g = close_grads(grads, jout[2])
    if opt == "sgd":
        close_trees(state.params, jout[0].params, 1e-6)
        for mine, ref in zip(state.ema_params, jout[0].ema_params):
            close_trees(mine, ref, 1e-6)
    else:  # Adam's first step: lr·sign(g) where |g| ≫ ε
        ref_p = flax_to_state_dict(jout[0].params)
        top = max(float(g.abs().max()) for g in ref_g.values())
        for k, v in state.params.items():
            big = ref_g[k].abs() > 1e-3 * top
            err = (v.detach() - ref_p[k]).abs()
            assert np.max(err[big].numpy(), initial=0.0) <= 1e-6, k
            assert np.max(err[~big].numpy(), initial=0.0) <= 2 * LR["adamw"], k
            assert float((v.detach() - before[k]).abs().max()) > 0, k
    if loss_aware:
        np.testing.assert_array_equal(sampler[0].counts.numpy(), np.asarray(jout[3].counts))
        np.testing.assert_allclose(sampler[0].history.numpy(),
                                   np.asarray(jout[3].history), rtol=1e-5)
        assert not torch.equal(sampler[0].history, tsampler.history)


def test_step_errors_leave_the_state(tiny):
    _, _, tm, x = tiny
    opt = _torch_opt("sgd")
    sched = DiffusionSchedule.linear()
    gen = lambda: torch.Generator().manual_seed(25)
    state = ttrain.create_train_state(tm.state_dict(), opt, n_ema=2)
    snapshot = {k: v.detach().clone() for k, v in state.params.items()}
    bad = ttrain.make_train_step(tm, sched, opt, ema_rate=(0.1, 0.2, 0.3))
    with pytest.raises(ValueError, match="EMA copies"):
        bad(state, nchw(x), gen())
    accum = ttrain.make_train_step(tm, sched, opt, ema_rate=(0.1, 0.2), accum_steps=3)
    with pytest.raises(ValueError, match="not divisible"):
        accum(state, nchw(x), gen())
    assert state.step == 0
    for k, v in state.params.items():
        assert torch.equal(v.detach(), snapshot[k]), k
    # a 1-tuple rate is the float: it works on the bare (n_ema=1) state
    one = ttrain.create_train_state(tm.state_dict(), opt)
    new, _ = ttrain.make_train_step(tm, sched, opt, ema_rate=(0.5,))(one, nchw(x), gen())
    assert isinstance(new.ema_params, dict) and new.step == 1
    with pytest.raises(ValueError, match="exactly one"):
        ttrain.make_train_step(tm, sched, opt)(one, nchw(x))


def test_flash_step_matches_pallas_interpret(plain_shapes):
    """ADM_TINY_1024 (1024 tokens, one head of 64) with attn 'flash': the
    port's step runs K2 forward and K4 + K5 backward (their plain versions
    on the CPU), JAX's its Pallas kernels in interpret mode."""
    px = ADM_TINY_1024["image_size"]
    jm = jmodels.UNetADM(jmodels.ADMConfig(**ADM_TINY_1024, attn_impl="flash"))
    params = flax_params(jm, jnp.zeros((1, px, px, 3)), jnp.float32(0.0), seed=26)
    tm = tmodels.load_flax_params(
        tmodels.UNetADM(tmodels.ADMConfig(**ADM_TINY_1024, attn_impl="flash")), params)
    x = (0.5 * np.random.default_rng(27).normal(size=(1, px, px, 3))).astype(np.float32)
    tiny = (jm, params, tm, x)
    key = jax.random.key(28)
    jout = run_jax(tiny, _jax_opt("sgd"), key, n_ema=1, ema_rate=0.9999,
                   learn_sigma_vb_weight=0.001)
    _, _, metrics, grads = run_port(tiny, _torch_opt("sgd"), jax_draws(key, x), n_ema=1,
                                    ema_rate=0.9999, learn_sigma_vb_weight=0.001)
    close_metrics(metrics, jout[1], 1e-4)
    close_grads(grads, jout[2], 1e-4)
    layers = sum(isinstance(m, tmodels.adm.ADMAttentionBlock) for m in tm.modules())
    assert {k: len(v) for k, v in plain_shapes.items()} == {
        "flash_forward_plain": 0, "flash_forward_lse_plain": layers,
        "flash_tangent_plain": 0, "flash_dq_plain": layers, "flash_dkv_plain": layers}
    assert set(plain_shapes["flash_dq_plain"]) == {(1, 1, 1024)}


def test_bf16_step_keeps_f32_masters(tiny):
    """A bf16 module trains f32 masters through a bf16 cast: params, EMA,
    gradients and Adam's moments stay f32, the module's own weights are
    untouched, and the loss is within 2e-2 of the f32 step's."""
    _, _, tm, x = tiny
    bf16 = tmodels.UNetADM(dataclasses.replace(tmodels.adm_tiny(SIZE), zero_init=False,
                                               dtype="bfloat16"))
    bf16.load_state_dict(tm.state_dict())
    own = {k: v.clone() for k, v in bf16.state_dict().items()}
    draws = jax_draws(jax.random.key(29), x)
    _, s32, m32, _ = run_port(tiny, _torch_opt("adamw"), draws)
    _, s16, m16, g16 = run_port(tiny, _torch_opt("adamw"), draws, model=bf16)
    assert s16.step == 1 and torch.isfinite(m16["loss"]) and torch.isfinite(m16["grad_norm"])
    np.testing.assert_allclose(float(m16["loss"]), float(m32["loss"]), rtol=2e-2)
    trees = [s16.params, *s16.ema_params, g16] + [
        s16.opt_state.state[p] for p in s16.params.values()]
    for tree in trees:
        for k, v in tree.items():
            if torch.is_tensor(v) and v.ndim:
                assert v.dtype == torch.float32, k
    assert all(torch.equal(v, own[k]) and v.dtype == torch.bfloat16
               for k, v in bf16.state_dict().items())


def _train(tm, opt, steps, n_ema=1, ema_rate=0.9999, seed=30):
    state = ttrain.create_train_state(tm.state_dict(), opt, n_ema=n_ema)
    step = ttrain.make_train_step(tm, DiffusionSchedule.linear(), opt, ema_rate=ema_rate)
    gen = torch.Generator().manual_seed(seed)
    x = 0.1 * torch.ones(2, 3, SIZE, SIZE)
    for _ in range(steps):
        state, _ = step(state, x, gen)
    return state, step, x


def _equal_states(a, b):
    assert a.step == b.step
    emas = lambda s: s.ema_params if isinstance(s.ema_params, tuple) else (s.ema_params,)
    for ta, tb in zip((a.params, *emas(a)), (b.params, *emas(b))):
        assert ta.keys() == tb.keys()
        assert all(torch.equal(ta[k].detach(), tb[k].detach()) for k in ta)
    sa, sb = a.opt_state.state_dict(), b.opt_state.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        assert all(torch.equal(v, sb["state"][i][n]) for n, v in st.items())


def test_checkpoint_save_restore(tiny, tmp_path):
    tm = tiny[2]
    opt = _torch_opt("adamw")
    state, step, x = _train(tm, opt, 3)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    with pytest.raises(FileNotFoundError):
        mgr.restore(ttrain.create_train_state(tm.state_dict(), opt))
    mgr.save(state)
    assert mgr.latest_step() == 3
    with pytest.raises(FileExistsError):
        mgr.save(state)
    restored = mgr.restore(ttrain.create_train_state(tm.state_dict(), opt))
    _equal_states(restored, state)
    # one more step from both copies, bit for bit
    t = torch.tensor([5, 700])
    draw = lambda i: (t, torch.ones(2), torch.full((2, 3, SIZE, SIZE), 0.3))
    a, _ = step(state, x, draw=draw)
    b, _ = step(restored, x, draw=draw)
    _equal_states(a, b)
    # gc keeps only the `keep` newest
    gen = torch.Generator().manual_seed(31)
    for _ in range(2):
        mgr.save(a)
        a, _ = step(a, x, gen)
    assert mgr.latest_step() == 5
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_00000004", "step_00000005"]


def test_checkpoint_multi_ema_roundtrip(tiny, tmp_path):
    tm = tiny[2]
    opt = _torch_opt("sgd")
    state, _, _ = _train(tm, opt, 1, n_ema=2, ema_rate=(0.0, 0.9))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state)
    restored = mgr.restore(ttrain.create_train_state(tm.state_dict(), opt, n_ema=2))
    assert isinstance(restored.ema_params, tuple) and len(restored.ema_params) == 2
    _equal_states(restored, state)
    with pytest.raises(ValueError, match="EMA"):
        mgr.restore(ttrain.create_train_state(tm.state_dict(), opt))


def test_checkpoint_save_that_raises_leaves_no_folder(tiny, tmp_path, monkeypatch):
    tm = tiny[2]
    state, _, _ = _train(tm, _torch_opt("sgd"), 1)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))

    def fail(obj, f):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(tckpt.torch, "save", fail)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(state)
    assert os.listdir(tmp_path / "ckpt") == [] and mgr.latest_step() is None
