"""The port's training losses and timestep samplers against the JAX package
on the CPU, f32, on the same seeded numpy inputs: every function of
training/losses.py within 1e-5 (vb_term with and without clip_x0, the t = 0
decoder branch and the ±1 pixel edges included), calc_bpd_loop at T = 8
with the same noise on a tiny learned-σ ADM net, and its refusal of
neither or both of generator and noise; loss_aware_weights before and after
the warm-up, update_loss_aware on batches with repeated t (exact), and the
samplers by range, shape and the importance weights' mean."""

import numpy as np
import pytest
import torch
from torch_port_common import flax_params, nchw, one_torch_thread  # noqa: F401

import jax.numpy as jnp

from diffusion_pullback_tpu import models as jmodels
from diffusion_pullback_tpu.ops import DiffusionSchedule as JSchedule
from diffusion_pullback_tpu.training import losses as jl
from diffusion_pullback_tpu.training import resample as jr
from diffusion_pullback_tpu_torch import models as tmodels
from diffusion_pullback_tpu_torch.ops.schedule import DiffusionSchedule
from diffusion_pullback_tpu_torch.training import losses as tl
from diffusion_pullback_tpu_torch.training import resample as tr

TOL = 1e-5


def _close(mine, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(mine), ref, rtol=0,
                               atol=tol * max(1.0, np.abs(ref).max()))


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _images(seed, shape=(4, 8, 8, 3)):
    """NHWC values in [−1, 1] with some pixels exactly at the ±1 edges (the
    discretised likelihood's end bins)."""
    x = np.tanh(_arrays(seed, shape)[0])
    x.reshape(-1)[:6] = [1.0, -1.0, 0.9995, -0.9995, 1.0, -1.0]
    return x


def test_normal_kl_and_cdf_match_jax():
    m1, l1, m2, l2 = _arrays(0, *[(3, 17)] * 4)
    _close(tl.normal_kl(*map(torch.from_numpy, (m1, l1, m2, l2))),
           jl.normal_kl(m1, l1, m2, l2))
    x = _arrays(1, (64,))[0] * 3
    _close(tl.approx_standard_normal_cdf(torch.from_numpy(x)),
           jl.approx_standard_normal_cdf(x))


def test_discretized_log_likelihood_matches_jax():
    """Means within 2 scales of x, and a few 50 scales away (both packages
    clamp those bins to log 1e-12). Between about 3 and 6 scales the bin's
    mass is the difference of two f32 CDF values near 1, and one ulp of
    tanh (XLA's and torch's differ) moves the log by up to 12 nats: there
    both packages are ~10 nats from the same formula in f64, so that range
    holds no comparison."""
    x = _images(2)
    u, log_scales = _arrays(3, x.shape, x.shape)
    log_scales = 0.5 * log_scales - 2.0
    u = np.clip(u, -2.0, 2.0)
    u.reshape(-1)[::17] = 50.0
    means = x - np.exp(log_scales) * u
    _close(tl.discretized_gaussian_log_likelihood(*map(nchw, (x, means, log_scales))),
           np.transpose(jl.discretized_gaussian_log_likelihood(x, means, log_scales),
                        (0, 3, 1, 2)))


T_CASES = [0.0, 0.5, 1.0, 137.0, 999.0]


def test_q_posterior_matches_jax():
    x0, xt = _images(4, (5, 8, 8, 3)), _arrays(5, (5, 8, 8, 3))[0]
    t = np.asarray(T_CASES, np.float32)
    mean, logvar = tl.q_posterior_mean_logvar(DiffusionSchedule.linear(), nchw(x0),
                                              nchw(xt), torch.from_numpy(t))
    jmean, jlogvar = jl.q_posterior_mean_logvar(JSchedule.linear(), x0, xt, t)
    _close(mean, np.transpose(jmean, (0, 3, 1, 2)))
    _close(logvar.reshape(-1), np.asarray(jlogvar).reshape(-1))


@pytest.mark.parametrize("clip_x0", [False, True], ids=["raw", "clip_x0"])
def test_vb_term_and_prior_match_jax(clip_x0):
    x0 = _images(6, (5, 8, 8, 3))
    xt, eps, logvar = _arrays(7, *[(5, 8, 8, 3)] * 3)
    logvar = np.tanh(logvar)
    t = np.asarray(T_CASES, np.float32)
    mine = tl.vb_term(DiffusionSchedule.linear(), nchw(x0), nchw(xt), torch.from_numpy(t),
                      nchw(eps), nchw(logvar), clip_x0=clip_x0)
    ref = jl.vb_term(JSchedule.linear(), x0, xt, t, eps, logvar, clip_x0=clip_x0)
    _close(mine, ref)
    _close(tl.prior_bpd(DiffusionSchedule.linear(), nchw(x0)),
           jl.prior_bpd(JSchedule.linear(), x0))


def test_calc_bpd_loop_matches_jax():
    """The full chain at T = 8 on adm_tiny(16) (learned σ) with the same
    weights and noise: every output, t ordered T−1 … 0."""
    T, size = 8, 16
    jm = jmodels.UNetADM(jmodels.adm_tiny(size))
    params = flax_params(jm, jnp.zeros((1, size, size, 3)), jnp.float32(0.0), seed=3)
    tm = tmodels.load_flax_params(tmodels.UNetADM(tmodels.adm_tiny(size)), params)
    x0 = _images(8, (2, size, size, 3))
    noise = _arrays(9, (T, 2, size, size, 3))[0]

    def jfn(xt, t):
        out = jm.apply(params, xt, t)
        return out[..., :3], out[..., 3:]

    def tfn(xt, t):
        out = tm(xt, t)
        return out[:, :3], out[:, 3:]

    ref = jl.calc_bpd_loop(JSchedule.linear(num_train_timesteps=T), jfn, x0,
                           noise=jnp.asarray(noise))
    mine = tl.calc_bpd_loop(DiffusionSchedule.linear(num_train_timesteps=T), tfn,
                            nchw(x0), noise=torch.from_numpy(
                                noise.transpose(0, 1, 4, 2, 3).copy()))
    assert set(mine) == set(ref)
    for name in ref:
        assert mine[name].shape == ref[name].shape, name
        _close(mine[name], ref[name])
    with pytest.raises(ValueError, match="exactly one"):
        tl.calc_bpd_loop(DiffusionSchedule.linear(num_train_timesteps=T), tfn, nchw(x0))
    with pytest.raises(ValueError, match="exactly one"):
        tl.calc_bpd_loop(DiffusionSchedule.linear(num_train_timesteps=T), tfn, nchw(x0),
                         generator=torch.Generator().manual_seed(0),
                         noise=torch.zeros(T, 2, 3, size, size))


def _states(T, per_term):
    return jr.init_loss_aware(T, per_term), tr.init_loss_aware(T, per_term)


def _same_state(mine, ref):
    np.testing.assert_array_equal(mine.history.numpy(), np.asarray(ref.history))
    np.testing.assert_array_equal(mine.counts.numpy(), np.asarray(ref.counts))


def test_loss_aware_weights_before_and_after_warm_up():
    T, per_term = 10, 4
    js, ts = _states(T, per_term)
    rng = np.random.default_rng(10)
    for i in range(per_term + 1):
        _close(tr.loss_aware_weights(ts), jr.loss_aware_weights(js), 1e-6)
        warmed = bool((ts.counts == per_term).all())
        assert warmed == (i == per_term)
        if not warmed:
            np.testing.assert_allclose(tr.loss_aware_weights(ts).numpy(),
                                       np.full(T, 1 / T), rtol=1e-6)
        losses = rng.uniform(0.5, 2.0, size=T).astype(np.float32)
        losses[3] *= 10
        js = jr.update_loss_aware(js, jnp.arange(T), jnp.asarray(losses))
        ts = tr.update_loss_aware(ts, torch.arange(T), torch.from_numpy(losses))
    w = tr.loss_aware_weights(ts)
    assert w[3] > 5 * w[0] and abs(w.sum().item() - 1.0) < 1e-5


@pytest.mark.parametrize("case", ["jax_test", "long"])
def test_update_loss_aware_repeats_shift_per_occurrence(case):
    """A t repeated in one batch shifts its ring buffer once per occurrence,
    in batch order: JAX's test_ring_buffer_update batch, and 6 batches of
    16 draws over 5 timesteps (every buffer fills and wraps)."""
    if case == "jax_test":
        batches = [(np.array([1, 1, 1]), np.array([1.0, 2.0, 3.0], np.float32))]
        js, ts = _states(4, 2)
    else:
        rng = np.random.default_rng(11)
        batches = [(rng.integers(0, 5, 16), rng.uniform(size=16).astype(np.float32))
                   for _ in range(6)]
        js, ts = _states(5, 3)
    for t, losses in batches:
        js = jr.update_loss_aware(js, jnp.asarray(t), jnp.asarray(losses))
        ts = tr.update_loss_aware(ts, torch.from_numpy(t), torch.from_numpy(losses))
        _same_state(ts, js)
    if case == "jax_test":
        np.testing.assert_array_equal(ts.history[1].numpy(), [2.0, 3.0])
        assert int(ts.counts[1]) == 2


def test_samplers_range_shape_and_weights():
    gen = torch.Generator().manual_seed(12)
    t, w = tr.uniform_sample_t(gen, 512, 1000)
    assert t.shape == (512,) and t.dtype == torch.int64
    assert int(t.min()) >= 0 and int(t.max()) < 1000
    np.testing.assert_array_equal(w.numpy(), np.ones(512, np.float32))

    T, per_term = 10, 4
    ts = tr.init_loss_aware(T, per_term)
    for _ in range(per_term):
        ts = tr.update_loss_aware(ts, torch.arange(T),
                                  torch.where(torch.arange(T) == 3, 10.0, 1.0))
    t, iw = tr.loss_aware_sample_t(ts, gen, 2048)
    assert t.shape == iw.shape == (2048,)
    assert int(t.min()) >= 0 and int(t.max()) < T
    assert float((t == 3).float().mean()) > 0.3  # heavily oversampled
    # the importance weights undo the bias in expectation: E[w] ≈ 1
    np.testing.assert_allclose(float(iw.mean()), 1.0, atol=0.15)
    p = tr.loss_aware_weights(ts)
    np.testing.assert_allclose(iw.numpy(), (1.0 / (T * p[t])).numpy())
