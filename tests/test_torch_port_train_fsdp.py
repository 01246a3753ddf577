"""The train step under a dp×fsdp mesh (training/train.py with ``mesh=``)
against the JAX package's: the first leg of its multi-device dry run
(__graft_entry__._dryrun_impl), the jitted JAX step with the batch over
'dp' and the params and optimizer state over 'fsdp' on the 8-device CPU
mesh (tests/conftest.py, dp 2 × fsdp 4), AdamW through an optax stage that
keeps the gradient it applied.

The port runs on 4 gloo ranks (tests/torch_port_dist.py, dp 2 × fsdp 2)
from the same ddpm_tiny(16) weights (carried by load_flax_params), batch
and draws (the JAX step's own t and noise, through the port step's
``draw``). One step: the loss and grad_norm within 1e-5 relative; the
gradient within 1e-5 of its largest entry; Adam's first moment within
1e-5 and its second within 2e-5 of their largest entries; the masters and
the EMA copy within 1e-6 where |g| > 1e-3·max|g| and within 2·lr
elsewhere (Adam's first step is lr·sign(g) wherever |g| ≫ ε, so two right
implementations part by 2·lr where g is rounding noise, such as an
attention key bias, which the softmax does not see). A second step with
draws from a generator against the port's single-process step on the same
generator (the whole batch's draws, each dp rank taking its rows); each
rank holds about half of every master."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_common import flax_params, nchw, one_torch_thread  # noqa: F401
from torch_port_dist import launch, train_body

from diffusion_pullback_tpu import models as jmodels
from diffusion_pullback_tpu import training as jtrain
from diffusion_pullback_tpu.ops import DiffusionSchedule as JSchedule
from diffusion_pullback_tpu_torch import models as tmodels
from diffusion_pullback_tpu_torch.models.convert import flax_to_state_dict
from diffusion_pullback_tpu_torch.ops.schedule import DiffusionSchedule
from diffusion_pullback_tpu_torch.training import create_train_state, make_train_step
from diffusion_pullback_tpu_torch.training.train import draws_of

LR, WD, EMA, BATCH, T = 1e-3, 1e-2, 0.9, 4, 1000


def run_jax(jm, params, x, key):
    """One jitted JAX step on a dp 2 × fsdp 4 mesh, sharded as the dry run
    shards it: (new state, metrics, the gradient it applied)."""
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), axis_names=("dp", "fsdp"))
    keep = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (g, g))
    tx = optax.chain(keep, optax.adamw(LR, weight_decay=WD))
    state = jtrain.create_train_state(params, tx)

    def param_spec(leaf):  # the dry run's: the largest axis fsdp divides
        for ax in sorted(range(leaf.ndim), key=lambda a: leaf.shape[a], reverse=True):
            if leaf.shape[ax] % 4 == 0:
                spec = [None] * leaf.ndim
                spec[ax] = "fsdp"
                return NamedSharding(mesh, P(*spec))
        return NamedSharding(mesh, P())

    repl = NamedSharding(mesh, P())
    state_sh = jax.tree.map(param_spec, state)
    step = jtrain.make_train_step(lambda p, xt, t: jm.apply(p, xt, t), JSchedule.linear(),
                                  tx, ema_rate=EMA)
    step = jax.jit(step, in_shardings=(state_sh, NamedSharding(mesh, P("dp")), repl),
                   out_shardings=(state_sh, repl))
    with mesh:
        new_state, metrics = step(jax.device_put(state, state_sh), jnp.asarray(x),
                                  jax.device_put(key, repl))
    return new_state, metrics, new_state.opt_state[0]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jm = jmodels.UNet2D(jmodels.ddpm_tiny(16))
    params = flax_params(jm, jnp.zeros((1, 16, 16, 3)), jnp.float32(0.0), seed=25)
    model = tmodels.load_flax_params(tmodels.UNet2D(tmodels.ddpm_tiny(16)), params)
    x = (0.5 * np.random.default_rng(26).normal(size=(BATCH, 16, 16, 3))).astype(np.float32)
    key = jax.random.key(27)
    jstate, jmetrics, jgrads = run_jax(jm, params, x, key)
    kt, kn = jax.random.split(key)  # the JAX step's draws at accum_steps 1
    t, w = jtrain.uniform_sample_t(kt, BATCH, T)
    noise = jax.random.normal(kn, x.shape, jnp.float32)
    data = dict(unet={k: v.numpy() for k, v in model.state_dict().items()},
                x0=nchw(x).numpy(), t=np.asarray(t).astype(np.int64), w=np.array(w),
                noise=nchw(np.asarray(noise)).numpy(), lr=LR, wd=WD, ema_rate=EMA)
    ranks = launch(train_body, 4, tmp_path_factory.mktemp("train"), data)

    adam = jstate.opt_state[1][0]  # adamw = chain(scale_by_adam, decay, lr)
    ref = dict(metrics={k: float(v) for k, v in jmetrics.items()},
               **{name: {k: v.numpy() for k, v in flax_to_state_dict(tree).items()}
                  for name, tree in (("params", jstate.params), ("ema", jstate.ema_params),
                                     ("grads", jgrads), ("mu", adam.mu), ("nu", adam.nu))})
    # the port's single-process step from the same state, then the same generator
    opt = functools.partial(torch.optim.AdamW, lr=LR, weight_decay=WD)
    state = create_train_state(model.state_dict(), opt)
    step = make_train_step(model, DiffusionSchedule.linear(), opt, ema_rate=EMA)
    state, _ = step(state, torch.from_numpy(data["x0"]), draw=draws_of(
        *(torch.from_numpy(data[k]) for k in ("t", "w", "noise"))))
    _, m2 = step(state, torch.from_numpy(data["x0"]), torch.Generator().manual_seed(7))
    ref["generator_metrics"] = {k: float(v) for k, v in m2.items()}
    return ranks, ref


def _close(mine, ref, tol):
    assert mine.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_allclose(mine[k], v, rtol=0, atol=tol, err_msg=k)


def test_metrics_match_jax(setup):
    ranks, ref = setup
    for r in ranks:
        got = r["metrics"][0]
        assert got["step"] == ref["metrics"]["step"] == 1
        for name in ("loss", "grad_norm"):
            assert got[name] == pytest.approx(ref["metrics"][name], rel=1e-5), name


def test_gradient_matches_jax(setup):
    ranks, ref = setup
    top = max(np.abs(v).max() for v in ref["grads"].values())
    for r in ranks:
        _close(r["grads"], ref["grads"], 1e-5 * top)


@pytest.mark.parametrize("moment,tol", [("mu", 1e-5), ("nu", 2e-5)])
def test_adam_moments_match_jax(setup, moment, tol):
    ranks, ref = setup
    top = max(np.abs(v).max() for v in ref[moment].values())
    for r in ranks:
        _close(r[moment], ref[moment], tol * top)


@pytest.mark.parametrize("tree", ["params", "ema"])
def test_masters_and_ema_match_jax(setup, tree):
    ranks, ref = setup
    top = max(np.abs(v).max() for v in ref["grads"].values())
    for r in ranks:
        assert r[tree].keys() == ref[tree].keys()
        for k, v in ref[tree].items():
            big = np.abs(ref["grads"][k]) > 1e-3 * top
            err = np.abs(r[tree][k] - v)
            assert np.max(err[big], initial=0.0) <= 1e-6, k
            assert np.max(err[~big], initial=0.0) <= 2 * LR, k


def test_generator_step_matches_the_single_process_step(setup):
    ranks, ref = setup
    want = ref["generator_metrics"]
    for r in ranks:
        got = r["metrics"][1]
        assert got["step"] == want["step"] == 2
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4)


def test_state_is_sharded_over_fsdp(setup):
    ranks, ref = setup
    total = sum(v.size for v in ref["params"].values())
    for r in ranks:  # each rank holds about half of every master
        assert total / 2 <= r["shard_elems"] < total / 2 + len(ref["params"])
