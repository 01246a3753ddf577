"""Multi-process gloo launches of the port's mesh paths on the CPU.

``launch(body, world, tmp_path, *args)`` starts ``world`` spawned ranks,
each joining one gloo process group through a file:// rendezvous in
``tmp_path`` (TCP ports collide across xdist workers) with one torch
thread, runs ``body(rank, *args)`` and returns the ranks' results (numpy
or plain Python) in rank order. A launch has a deadline: a rank that
raises, or a collective that deadlocks, fails the test instead of running
into the suite's time limit. The bodies live here, so a rank imports
torch and the port, never jax.
"""

from __future__ import annotations

import contextlib
import os
import queue
import traceback
import uuid

import numpy as np
import torch


def _rank_main(body, rank, world, init, args, results):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
        out = body(rank, *args)
        results.put((rank, "ok", out))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(body, world: int, tmp_path, *args, timeout: float = 150.0):
    import time

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    init = f"file://{os.path.join(str(tmp_path), 'rdzv-' + uuid.uuid4().hex)}"
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(body, r, world, init, args, results),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout
    try:
        while len(out) < world:
            try:
                rank, status, value = results.get(
                    timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                raise TimeoutError(f"{body.__name__} on {world} ranks: ranks "
                                   f"{sorted(set(range(world)) - set(out))} gave no "
                                   f"result in {timeout} s (deadlock?)") from None
            if status == "error":
                raise RuntimeError(f"{body.__name__}: rank {rank} raised:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join()
    return [out[r] for r in range(world)]


def np_tree(x):
    """Tensors (and tuples of them, NamedTuples included) as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple):
        parts = [np_tree(t) for t in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return x


def mesh(axes, shape=None):
    from diffusion_pullback_tpu_torch.parallel import make_mesh

    return make_mesh(tuple(axes), shape=shape, device="cpu")


@contextlib.contextmanager
def one_rank(tmp_path):
    """This process as the one rank of a gloo group (a file:// rendezvous in
    ``tmp_path``) for the block: a mesh's code paths at world size 1."""
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(str(tmp_path), 'rdzv-' + uuid.uuid4().hex)}",
        rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---- ring attention ----------------------------------------------------------

def ring_body(rank, data):
    """Ring attention on a 4-rank world, every case the JAX ring tests run
    (tests/test_ring_attention.py) and the AD modes under vmap; each rank's
    outputs (they are replicated)."""
    from torch.func import jvp, vjp, vmap

    from diffusion_pullback_tpu_torch.ops.attention import attention
    from diffusion_pullback_tpu_torch.parallel import ring_attention, set_ring_mesh

    T = lambda arrs, dtype=torch.float32: tuple(torch.from_numpy(a).to(dtype) for a in arrs)
    sp2 = mesh(("probe", "sp"), {"probe": 2, "sp": 2})   # sp 2, no dp axis
    sp4 = mesh(("sp",), {"sp": 4})
    dp_sp = mesh(("dp", "sp"), {"dp": 2, "sp": 2})
    out = {}
    for name, m in (("sp2", sp2), ("sp4", sp4)):
        out[f"xla_{name}"] = ring_attention(*T(data["f32"]), mesh=m, inner="xla")
        out[f"flash_{name}"] = ring_attention(*T(data["flash"]), mesh=m, inner="flash")
    out["bf16_sp2"] = ring_attention(*T(data["f32"], torch.bfloat16), mesh=sp2).float()
    out["rect_sp4"] = ring_attention(*T(data["rect"]), mesh=sp4)
    for inner in ("xla", "flash"):  # the default inner is the math path here
        out[f"bf16_512_{inner}_sp4"] = ring_attention(
            *T(data["bf16_512"], torch.bfloat16), mesh=sp4,
            **({"inner": "flash"} if inner == "flash" else {})).float()
    for sq in (576, 254):
        out[f"odd_{sq}"] = ring_attention(*T(data[f"odd_{sq}"]), mesh=sp2, inner="flash")
    out["dp_sp"] = ring_attention(*T(data["dp"]), mesh=dp_sp)
    try:
        ring_attention(*T(data["nondiv"]), mesh=sp4)
        out["nondiv"] = "no error"
    except ValueError as e:
        out["nondiv"] = str(e)
    # both AD modes, alone and under vmap over three tangents / cotangents
    q, k, v = T(data["ad"])
    ring = lambda q, k, v: ring_attention(q, k, v, mesh=sp4, inner="xla")
    tq, tk, tv = T(data["ad_tangents"])
    out["ad_jvp"] = jvp(ring, (q, k, v), (tq[0], tk[0], tv[0]))[1]
    out["ad_vmap_jvp"] = vmap(lambda a, b, c: jvp(ring, (q, k, v), (a, b, c))[1])(tq, tk, tv)
    _, pull = vjp(ring, q, k, v)
    out["ad_vjp"] = torch.stack(pull(tq[0]))
    out["ad_vmap_vjp"] = torch.stack(vmap(pull)(tq))
    # the dispatcher over the published mesh
    set_ring_mesh(sp4)
    for name in ("disp_ring", "disp_short", "disp_77"):
        out[name] = attention(*T(data[name]), impl="ring")
    out["disp_ring_xla"] = attention(*T(data["disp_ring"]), impl="ring_xla")
    set_ring_mesh(None)
    return {k: np_tree(v) for k, v in out.items()}


# ---- the probe-sharded pullback and the dp sweep -----------------------------

def _ddpm_encoder(state, size, t):
    from diffusion_pullback_tpu_torch.models import TapPoint, UNet2D, ddpm_tiny

    model = UNet2D(ddpm_tiny(size))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    model.eval().requires_grad_(False)
    tap = TapPoint("mid", 0)
    return lambda z: model.encode(z.permute(0, 3, 1, 2), t, tap).permute(0, 2, 3, 1)


def pullback_body(rank, data):
    """The probe-sharded pullback of ddpm_tiny(16)'s mid tap over a 4-rank
    'probe' axis from injected probes, with and without fn_vjp; the dp
    sweep of an MLP's pullbacks over a 4-rank 'dp' axis; the same sweep on
    a 2×2 dp×probe mesh, each pullback's probes sharded; and the errors."""
    from diffusion_pullback_tpu_torch.geometry import local_pullback
    from diffusion_pullback_tpu_torch.parallel import (dp_vmap, make_sharded_pullback,
                                                       sharded_local_pullback)

    enc = _ddpm_encoder(data["unet"], 16, data["t"])
    x, v0 = torch.from_numpy(data["x"]), torch.from_numpy(data["v0"])
    probe = mesh(("probe",))
    kw = dict(pca_rank=8, min_iter=3, max_iter=3, atol=0.0, v_init=v0)
    out = {"probe": sharded_local_pullback(enc, x, None, probe, **kw),
           "probe_vjp": make_sharded_pullback(lambda z, s: enc(z) * s, probe,
                                              fn_vjp=lambda z, s: enc(z) * s,
                                              **kw)(x, None, 1.0)}
    w1, w2 = torch.from_numpy(data["w1"]), torch.from_numpy(data["w2"])
    f = lambda z: torch.tanh(torch.tanh(z @ w1) @ w2)

    def pull_one(xi, vi, group=None):
        return local_pullback(f, xi[None], None, pca_rank=4, min_iter=3, max_iter=5,
                              atol=0.0, v_init=vi, probe_group=group)

    xs, vs = torch.from_numpy(data["xs"]), torch.from_numpy(data["vs"])
    out["dp"] = dp_vmap(pull_one, mesh(("dp",)))(xs, vs)
    dp_probe = mesh(("dp", "probe"), {"dp": 2, "probe": 2})
    out["dp_probe"] = dp_vmap(lambda a, b: pull_one(a, b, dp_probe.get_group("probe")),
                              dp_probe)(xs, vs)
    errors = {}
    for name, call in (
            ("rank", lambda: sharded_local_pullback(enc, x, None, probe, pca_rank=6)),
            ("chunk", lambda: local_pullback(enc, x, None, pca_rank=8, chunk_size=2,
                                             probe_group=probe.get_group("probe")))):
        try:
            call()
            errors[name] = "no error"
        except ValueError as e:
            errors[name] = str(e)
    out = {k: np_tree(v) for k, v in out.items()}
    out["errors"] = errors
    return out


# ---- tensor parallelism ------------------------------------------------------

def tp_body(rank, data):
    """sd_tiny_unet(8) on a 2×2 dp×tp mesh (the batch over dp, the weights
    over tp) with its specs' sharded count; a GEGLU feed-forward at tp=2
    (forward, jvp, vjp); the uncond mid-tap pullback of a two-head DDPM
    U-Net at tp=2 (a 'tp' mesh of 2 inside each half of the world)."""
    from torch.func import jvp, vjp

    from diffusion_pullback_tpu_torch.geometry import local_pullback
    from diffusion_pullback_tpu_torch.models import (TapPoint, UNet2D, UNet2DCondition,
                                                     sd_tiny_unet)
    from diffusion_pullback_tpu_torch.models.transformer2d import FeedForward
    from diffusion_pullback_tpu_torch.parallel import (tp_param_specs, tp_shard_params,
                                                       tp_sharded_leaf_count)
    from diffusion_pullback_tpu_torch.parallel.collectives import gather_rows

    load = lambda m, sd: m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    out = {}
    dp_tp = mesh(("dp", "tp"), {"dp": 2, "tp": 2})
    unet = UNet2DCondition(sd_tiny_unet(8)).eval().requires_grad_(False)
    load(unet, data["sd_unet"])
    specs = tp_param_specs(unet, dp_tp)
    out["count"] = tp_sharded_leaf_count(specs)
    out["sharded"] = sorted(k for k, d in specs.items() if d is not None)
    tp_shard_params(unet, dp_tp)
    dp_group = dp_tp.get_group("dp")
    me = torch.distributed.get_rank(dp_group)
    xs, ctx = torch.from_numpy(data["x"]), torch.from_numpy(data["ctx"])
    rows = slice(2 * me, 2 * me + 2)
    with torch.no_grad():
        eps = unet(xs[rows].permute(0, 3, 1, 2), data["t"], ctx[rows])
    out["sd_eps"] = gather_rows(eps.permute(0, 2, 3, 1).contiguous(), dp_group)

    tp = mesh(("probe", "tp"), {"probe": 2, "tp": 2})
    ff = FeedForward(8)
    load(ff, data["ff"])
    tp_shard_params(ff, tp)
    y, ty = (torch.from_numpy(a) for a in (data["ff_x"], data["ff_t"]))
    out["ff"] = ff(y)
    out["ff_jvp"] = jvp(ff, (y,), (ty,))[1]
    out["ff_vjp"] = vjp(ff, y)[1](ty)[0]

    ddpm = UNet2D(data["ddpm_cfg"]).eval().requires_grad_(False)
    load(ddpm, data["ddpm"])
    tp_shard_params(ddpm, tp)
    out["ddpm_heads"] = [m.heads for m in ddpm.modules() if hasattr(m, "heads")]
    enc = lambda z: ddpm.encode(z.permute(0, 3, 1, 2), data["t"], TapPoint("mid", 0)
                                ).permute(0, 2, 3, 1)
    out["ddpm_pullback"] = local_pullback(
        enc, torch.from_numpy(data["ddpm_x"]), None, pca_rank=4, min_iter=3,
        max_iter=3, atol=0.0, v_init=torch.from_numpy(data["ddpm_v0"]))
    return {k: np_tree(v) for k, v in out.items()}


# ---- the drivers under a mesh ------------------------------------------------

def uncond_driver(state, cfg, root, mesh_=None, model_cfg=None):
    """The port's EditUncondDiffusion on ddpm_tiny(16) (or ``model_cfg``)
    with ``state``'s weights, four seeded noise images, folders under
    ``root``."""
    from diffusion_pullback_tpu_torch import experiments as texp
    from diffusion_pullback_tpu_torch.models import UNet2D, ddpm_tiny
    from diffusion_pullback_tpu_torch.ops.schedule import DiffusionSchedule
    from diffusion_pullback_tpu_torch.utils.datasets import NoiseDataset
    from diffusion_pullback_tpu_torch.utils.logging import JSONLLogger

    model = UNet2D(model_cfg or ddpm_tiny(16))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    folders = {f"{k}_folder": os.path.join(str(root), k) for k in ("result", "basis", "obs")}
    return texp.EditUncondDiffusion(
        model, DiffusionSchedule.linear(), NoiseDataset(16, n=4),
        texp.UncondExperimentConfig(**cfg, **folders, mesh=mesh_),
        logger=JSONLLogger(os.path.join(str(root), "log.jsonl"), echo=False), device="cpu")


def sd_driver(cfg, root, mesh_, sd):
    """The port's EditStableDiffusion on the tiny SD models of ``sd``: the
    U-Net and text-tower configs and the JAX package's param trees of the
    U-Net, the VAE (at 2·latent px) and the tower, carried by
    load_flax_params; folders under ``root``."""
    from diffusion_pullback_tpu_torch import experiments as texp
    from diffusion_pullback_tpu_torch import models as tm
    from diffusion_pullback_tpu_torch.ops.schedule import DiffusionSchedule
    from diffusion_pullback_tpu_torch.utils.datasets import NoiseDataset
    from diffusion_pullback_tpu_torch.utils.logging import JSONLLogger

    px = 2 * sd["ucfg"].sample_size
    folders = {f"{k}_folder": os.path.join(str(root), k) for k in ("result", "basis", "obs")}
    return texp.EditStableDiffusion(
        tm.load_flax_params(tm.UNet2DCondition(sd["ucfg"]), sd["unet"]),
        tm.load_flax_params(tm.AutoencoderKL(tm.vae_tiny(px)), sd["vae"]),
        tm.load_flax_params(tm.CLIPTextModel(sd["tcfg"]), sd["text"]),
        DiffusionSchedule.scaled_linear(), NoiseDataset(px, n=1),
        texp.SDExperimentConfig(**cfg, **folders, mesh=mesh_),
        logger=JSONLLogger(os.path.join(str(root), "log.jsonl"), echo=False), device="cpu")


def same_start(drv, data, xT=True):
    """Every pullback the uncond driver runs started from data['v0'] and,
    with ``xT``, its inversions replaced by data['xT'][idx] (as
    torch_port_common's uncond_same_start does for a driver pair)."""
    from diffusion_pullback_tpu_torch.experiments import edit_uncond

    if xT:
        drv.run_ddim_inversion = lambda idx: torch.from_numpy(data["xT"][idx])
    real = getattr(edit_uncond.local_pullback, "real", edit_uncond.local_pullback)
    pull = lambda *a, **kw: real(*a, **{**kw, "v_init": torch.from_numpy(data["v0"])})
    pull.real = real
    edit_uncond.local_pullback = pull


def drivers_body(rank, data):
    """Every rank runs the drivers of tests/test_torch_port_mesh_drivers.py
    on its meshes; each returns its bases, what it wrote and what it read."""
    from diffusion_pullback_tpu_torch.experiments import edit_sd
    from diffusion_pullback_tpu_torch.experiments.cache import load_basis
    from diffusion_pullback_tpu_torch.models import TapPoint

    root, cfg, out = data["root"], data["cfg"], {}
    tap = TapPoint("mid", 0)
    t_edit = lambda d: d.fwd_grid.timesteps[d.edit_t_idx]
    # the probe-sharded pullback of the uncond driver, and an edit's files
    drv = uncond_driver(data["unet"], cfg, os.path.join(root, "probe"), mesh(("probe",)))
    same_start(drv, data)
    xt = drv.forward_to_edit_t(drv.run_ddim_inversion(0))
    out["probe"] = np_tree(drv.compute_local_basis(xt, t_edit(drv), tap, 8))
    out["probe_shards"] = drv._mesh_probe_size(8)
    out["edit"] = drv.run_edit_local_encoder_pullback_xt(0, pca_rank=8)
    out["writer_log"] = drv.log._fh is not None
    # the dp sweeps: the t-grid harvest from x_T, the sample harvest from
    # the dataset's images (the JAX driver inverts them inside its sweep)
    drv = uncond_driver(data["unet"], cfg, os.path.join(root, "dp"), mesh(("dp",)))
    same_start(drv, data)
    files = drv.run_sample_encoder_local_tangent_space_xt_batched(
        0, pca_rank=8, t_grid=data["grid"])
    out["grid"] = {et: load_basis(p) for et, p in files.items()}
    drv = uncond_driver(data["unet"], cfg, os.path.join(root, "dps"), mesh(("dp",)))
    same_start(drv, data, xT=False)
    out["samples"] = {i: np_tree(b) for i, b in drv._harvest_bases([1, 2, 3], "mid", 0, 8).items()}
    # the prompt sweep on a dp×probe mesh, from the same z_T and probes
    sd = sd_driver(data["sd_cfg"], os.path.join(root, "sd"),
                   mesh(("dp", "probe"), {"dp": 2, "probe": 2}), data["sd"])
    sd.run_DDIMinversion = lambda idx: torch.from_numpy(data["sd"]["zT"])
    real = edit_sd.local_encoder_pullback
    edit_sd.local_encoder_pullback = lambda *a, **kw: real(
        *a, **{**kw, "v_init": torch.from_numpy(data["sd"]["v0"])})
    files = sd.run_sample_encoder_local_tangent_space_zt_various_prompt(
        data["prompts"], idx=0, pca_rank=4)
    out["prompts"] = {p: load_basis(f) for p, f in files.items()}
    # the tensor-parallel driver of a two-head U-Net
    drv = uncond_driver(data["unet2"], cfg, os.path.join(root, "tp"),
                        mesh(("dp", "tp"), {"dp": 2, "tp": 2}), data["cfg2"])
    same_start(drv, data)
    xt = drv.forward_to_edit_t(drv.run_ddim_inversion(0))
    out["tp"] = np_tree(drv.compute_local_basis(xt, t_edit(drv), tap, 8))
    return out


# ---- training under a dp×fsdp mesh -------------------------------------------

def train_body(rank, data):
    """Training on a 2×2 dp×fsdp mesh from the whole state: one AdamW step
    of ddpm_tiny(16) with the JAX step's t and noise injected, then one with
    draws from a generator. After the first step the masters, the EMA
    copy, the gradient the step applied and Adam's two moments, gathered
    back whole, and the size of this rank's shards; the metrics of both."""
    import functools

    from diffusion_pullback_tpu_torch.models import UNet2D, ddpm_tiny
    from diffusion_pullback_tpu_torch.ops.schedule import DiffusionSchedule
    from diffusion_pullback_tpu_torch.training import (create_train_state, gather_params,
                                                       make_train_step)
    from diffusion_pullback_tpu_torch.training.train import draws_of

    model = UNet2D(ddpm_tiny(16))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in data["unet"].items()})
    opt = functools.partial(torch.optim.AdamW, lr=data["lr"], weight_decay=data["wd"])
    m = mesh(("dp", "fsdp"), {"dp": 2, "fsdp": 2})
    state = create_train_state(model.state_dict(), opt, mesh=m)
    step = make_train_step(model, DiffusionSchedule.linear(), opt,
                           ema_rate=data["ema_rate"], mesh=m)
    x0 = torch.from_numpy(data["x0"])
    draws = draws_of(*(torch.from_numpy(data[k]) for k in ("t", "w", "noise")))
    state, m1 = step(state, x0, draw=draws)
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    whole = lambda tree: {k: v.numpy() for k, v in gather_params(tree, shapes, m).items()}
    adam = lambda name: {k: state.opt_state.state[p][name] for k, p in state.params.items()}
    out = dict(params=whole(state.params), ema=whole(state.ema_params),
               grads=whole({k: p.grad for k, p in state.params.items()}),
               mu=whole(adam("exp_avg")), nu=whole(adam("exp_avg_sq")),
               shard_elems=sum(v.numel() for v in state.params.values()))
    state, m2 = step(state, x0, torch.Generator().manual_seed(7))
    out["metrics"] = [{k: float(v) for k, v in mm.items()} for mm in (m1, m2)]
    return out


# ---- the mesh and the collectives --------------------------------------------

def mesh_body(rank, data):
    """build_mesh's grammar at 4 ranks, the mesh's departure (a shape that
    does not cover the world raises), ``agreed``, and each collective
    against its single-process meaning under jvp, vjp and vmap."""
    from torch.func import jvp, vjp, vmap

    from diffusion_pullback_tpu_torch import main as tmain
    from diffusion_pullback_tpu_torch.parallel import collectives as C
    from diffusion_pullback_tpu_torch.parallel.mesh import agreed, mesh_shape

    out = {}
    for spec in data["specs"]:
        args = tmain.parse_args(["--note", "x", "--device", "cpu", "--mesh_axes", spec])
        m = tmain.build_mesh(args)
        out[spec] = None if m is None else mesh_shape(m)
    try:
        mesh(("tp",), {"tp": 2})
        out["prefix"] = "no error"
    except ValueError as e:
        out["prefix"] = str(e)
    out["agreed"] = agreed(rank == 0), agreed(rank == 1)
    g = mesh(("dp", "sp"), {"dp": 2, "sp": 2}).get_group("sp")
    me = torch.distributed.get_rank(g)
    x = torch.from_numpy(data["x"])            # (2, 6, 4), replicated
    ts = torch.from_numpy(data["ts"])           # (3, 2, 6, 4)
    ops = {  # op on the replicated x, and its single-process meaning
        "gather": (lambda y: C.gather(C.shard(y, 1, g).sin(), 1, g), lambda y: y.sin()),
        "region": (lambda y: C.all_reduce(C.copy_to_region(y, g) * (me + 1.0), g),
                   lambda y: y * 3.0),
        "ring": (lambda y: C.gather(C.ring_shift(C.shard(y, 1, g) ** 2, g), 1, g),
                 lambda y: torch.roll(y ** 2, 3, dims=1)),
    }
    for name, (f, ref) in ops.items():
        got = [f(x), jvp(f, (x,), (ts[0],))[1],
               vmap(lambda t: jvp(f, (x,), (t,))[1])(ts)]
        want = [ref(x), jvp(ref, (x,), (ts[0],))[1],
                vmap(lambda t: jvp(ref, (x,), (t,))[1])(ts)]
        cot = lambda fn: vjp(fn, x)[1]
        cts = torch.stack([ref(x) * 0 + c for c in range(1, 4)]) + ts[:, :, :ref(x).shape[1]]
        got += [cot(f)(cts[0])[0], vmap(cot(f))(cts)[0]]
        want += [cot(ref)(cts[0])[0], vmap(cot(ref))(cts)[0]]
        out[name] = max((a - b).abs().max().item() for a, b in zip(got, want))
    return out
