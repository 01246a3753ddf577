"""The port's post-edit regularizers, Fourier noise shaping and
DiffusionSchedule.t_max against the JAX package on the CPU, f32.

Gates: the regularizers within 1e-6 of max(1, max |ref|) (elementwise maps
and per-sample reductions over at most 3·16·16 values; float32 reductions
in another order differ by a few ulps); fourier_regularization within 1e-5
of max(1, max |ref|) (two orthonormal FFTs of 16×16×3 in f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401

from diffusion_pullback_tpu.ops import fourier as jfourier
from diffusion_pullback_tpu.ops.schedule import DiffusionSchedule as JSchedule
from diffusion_pullback_tpu.samplers import regularizers as jreg
from diffusion_pullback_tpu_torch.ops import fourier as tfourier
from diffusion_pullback_tpu_torch.ops.schedule import DiffusionSchedule
from diffusion_pullback_tpu_torch.samplers import regularizers as treg


def close(out, ref, tol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


def _batch(seed, b, scale=1.0, shift=0.0):
    """NHWC frames with per-sample scale and offset, so the per-sample
    statistics differ from sample to sample."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, 8, 8, 3)) * scale * (1 + np.arange(b))[:, None, None, None]
    return (x + shift * np.arange(b)[:, None, None, None]).astype(np.float32)


@pytest.mark.parametrize("ref_batch", [4, 1], ids=["per-sample", "batch-1-reference"])
@pytest.mark.parametrize("name", ["preserve_norm", "preserve_contrast"])
def test_reference_regularizers_match_jax(name, ref_batch):
    x, ref = _batch(0, 4, shift=0.5), _batch(1, ref_batch, scale=2.0, shift=-1.0)
    mine = getattr(treg, name)(torch.from_numpy(x), torch.from_numpy(ref))
    close(mine, getattr(jreg, name)(jnp.asarray(x), jnp.asarray(ref)), 1e-6)


@pytest.mark.parametrize("name", ["preserve_norm", "preserve_contrast"])
def test_reference_batch_mismatch_raises(name):
    x, ref = _batch(0, 4), _batch(1, 3)
    with pytest.raises(ValueError, match="reference batch 3 incompatible with edit batch 4"):
        getattr(treg, name)(torch.from_numpy(x), torch.from_numpy(ref))
    with pytest.raises(ValueError, match="reference batch 3 incompatible"):
        getattr(jreg, name)(jnp.asarray(x), jnp.asarray(ref))


def test_population_std():
    """SEGA's threshold σ·std(v) moves with the std's correction: on this v
    a port on torch.std's default (correction 1) keeps fewer components
    than JAX. preserve_contrast's ratio of two stds over equal sizes does
    not depend on it; its values are checked here against the formula."""
    v = np.asarray([0.5, -1.0, 2.0, 0.1, -0.2, 1.2], np.float32)
    assert ((np.abs(v) >= v.std()) != (np.abs(v) >= v.std(ddof=1))).any()
    want = np.asarray(jreg.sega_sparsify(jnp.asarray(v), 1.0))
    np.testing.assert_array_equal(treg.sega_sparsify(torch.from_numpy(v), 1.0).numpy(),
                                  want)
    np.testing.assert_array_equal(want != 0, np.abs(v) >= v.std())
    x = np.asarray([[1.0, 3.0], [0.0, 4.0]], np.float32)
    ref = np.asarray([[2.0, 6.0]], np.float32)
    close(treg.preserve_contrast(torch.from_numpy(x), torch.from_numpy(ref)),
          [[2.0, 6.0], [2.0, 6.0]], 1e-6)


@pytest.mark.parametrize("q", [0.8, 0.5, 0.95])
def test_dynamic_thresholding_matches_jax(q):
    x = _batch(2, 3, shift=0.3)
    mine = treg.dynamic_thresholding(torch.from_numpy(x), q)
    close(mine, jreg.dynamic_thresholding(jnp.asarray(x), q), 1e-6)
    flat = np.abs(x.reshape(3, -1))
    assert (mine.abs().reshape(3, -1).amax(1).numpy()
            <= np.quantile(flat, q, axis=1) + 1e-6).all()


@pytest.mark.parametrize("sigma", [1.0, 0.5, 2.0])
def test_sega_sparsify_matches_jax(sigma):
    v = _batch(3, 1).reshape(-1) * np.float32(0.01)
    mine = treg.sega_sparsify(torch.from_numpy(v), sigma)
    want = np.asarray(jreg.sega_sparsify(jnp.asarray(v), sigma))
    np.testing.assert_array_equal(mine.numpy(), want)
    assert 0 < np.count_nonzero(want) < v.size


@pytest.mark.parametrize("smoothing", [False, True], ids=["plain", "fft_smoothing"])
def test_fourier_regularization_matches_jax(smoothing):
    rng = np.random.default_rng(4)
    src = rng.normal(size=(16, 16, 3)).astype(np.float32)
    pert = (src + 0.3 * rng.normal(size=(16, 16, 3))).astype(np.float32)
    mine = tfourier.fourier_regularization(torch.from_numpy(src), torch.from_numpy(pert),
                                           1.0, 0.5, fft_smoothing=smoothing)
    want = jfourier.fourier_regularization(jnp.asarray(src), jnp.asarray(pert), 1.0, 0.5,
                                           fft_smoothing=smoothing)
    assert mine.dtype == torch.float32 and mine.shape == (16, 16, 3)
    close(mine, want, 1e-5)


def test_match_histograms_needs_scikit_image():
    try:
        import skimage  # noqa: F401
        have = True
    except ImportError:
        have = False
    x = np.zeros((4, 4, 3), np.float32)
    if have:
        assert tfourier.match_histograms(torch.from_numpy(x), x).shape == x.shape
        return
    for mod in (tfourier, jfourier):
        with pytest.raises(RuntimeError, match="requires scikit-image"):
            mod.match_histograms(x, x)


@pytest.mark.parametrize("name", ["linear", "cosine", "scaled_linear"])
def test_t_max_matches_jax(name):
    mine, theirs = DiffusionSchedule.from_name(name), JSchedule.from_name(name)
    assert mine.t_max == theirs.t_max == 999
    assert DiffusionSchedule.linear(num_train_timesteps=50).t_max == 49
