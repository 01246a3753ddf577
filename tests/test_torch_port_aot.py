"""The port's program export cache (diffusion_pullback_tpu_torch/utils/aot.py)
against the JAX package's (diffusion_pullback_tpu/utils/aot.py): the six
tests of tests/test_aot.py on the port's cache, each program's output held
to the JAX cache's on the same numpy inputs, and a tiny SD U-Net's ε
program, which reaches K1 (the custom op dpx::flash_fwd, its plain version
on the CPU), stored without its weights and reloaded with the eager output.
Runs on the CPU."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401

from diffusion_pullback_tpu.utils.aot import AOTProgramCache as JAXCache
from diffusion_pullback_tpu_torch import models as tmodels
from diffusion_pullback_tpu_torch.experiments._common import DriverCommonMixin
from diffusion_pullback_tpu_torch.utils import aot
from diffusion_pullback_tpu_torch.utils.aot import AOTProgramCache


def f(a, b):
    return torch.tanh(a @ b) * 2.0


def jf(a, b):
    return jnp.tanh(a @ b) * 2.0


@pytest.fixture
def args():
    rng = np.random.default_rng(0)
    return rng.standard_normal((4, 8), np.float32), rng.standard_normal((8, 3), np.float32)


def torch_args(args):
    return tuple(torch.from_numpy(a) for a in args)


@pytest.fixture
def no_export(monkeypatch):
    """torch.export.export made to raise: a call must load, not export."""
    def refuse(*a, **k):
        raise AssertionError("exported again instead of loading")
    monkeypatch.setattr(torch.export, "export", refuse)


def test_export_roundtrip(tmp_path, args, monkeypatch):
    cache = AOTProgramCache(str(tmp_path))
    out1 = cache.wrap("f", f)(*torch_args(args))
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].name.endswith(".pt2")

    def refuse(*a, **k):
        raise AssertionError("exported again instead of loading")
    monkeypatch.setattr(torch.export, "export", refuse)
    out2 = AOTProgramCache(str(tmp_path)).wrap("f", f)(*torch_args(args))
    torch.testing.assert_close(out2, out1, rtol=0, atol=0)
    jout = JAXCache(str(tmp_path / "jax")).wrap("f", jf)(*map(jnp.asarray, args))
    np.testing.assert_allclose(out1.numpy(), np.asarray(jout), atol=1e-6)


def test_distinct_shapes_get_distinct_exports(tmp_path, args):
    run = AOTProgramCache(str(tmp_path)).wrap("f", f)
    run(*torch_args(args))
    out = run(torch.zeros(2, 8), torch.zeros(8, 3))
    assert out.shape == (2, 3)
    assert len(list(tmp_path.iterdir())) == 2
    jrun = JAXCache(str(tmp_path / "jax")).wrap("f", jf)
    jrun(*map(jnp.asarray, args))
    jrun(jnp.zeros((2, 8)), jnp.zeros((8, 3)))
    assert len(list((tmp_path / "jax").iterdir())) == 2


def test_fail_open_on_unwritable_dir(tmp_path, args):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("a file where the export folder should go")
    out = AOTProgramCache(str(blocker)).wrap("f", f)(*torch_args(args))
    jout = JAXCache(str(blocker)).wrap("f", jf)(*map(jnp.asarray, args))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-6)
    torch.testing.assert_close(out, f(*torch_args(args)), rtol=0, atol=0)


def test_pytree_args_key(tmp_path):
    g = lambda tree: tree["a"] * tree["b"]["c"] + 1.0
    tree = {"a": np.ones(3, np.float32), "b": {"c": np.full(3, 2.0, np.float32)}}
    out = AOTProgramCache(str(tmp_path)).wrap("g", g)(
        jax.tree.map(torch.from_numpy, tree))
    jout = JAXCache(str(tmp_path / "jax")).wrap("g", g)(jax.tree.map(jnp.asarray, tree))
    np.testing.assert_allclose(out.numpy(), np.full(3, 3.0))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout))
    assert len([p for p in tmp_path.iterdir() if p.is_file()]) == 1


def test_fingerprint_separates_exports(tmp_path, args, monkeypatch):
    """Two wraps with the same name and arguments but other fingerprints
    do not share a file, and each replays its own constant."""
    cache = AOTProgramCache(str(tmp_path))
    mk = lambda s: (lambda a, b: torch.tanh(a @ b) * s)
    out1 = cache.wrap("f", mk(2.0), fingerprint="s2")(*torch_args(args))
    out2 = cache.wrap("f", mk(5.0), fingerprint="s5")(*torch_args(args))
    assert len(list(tmp_path.iterdir())) == 2
    torch.testing.assert_close(out2, out1 * 2.5, rtol=1e-5, atol=1e-5)

    def refuse(*a, **k):
        raise AssertionError("exported again instead of loading")
    monkeypatch.setattr(torch.export, "export", refuse)
    cache2 = AOTProgramCache(str(tmp_path))
    torch.testing.assert_close(cache2.wrap("f", mk(2.0), fingerprint="s2")(
        *torch_args(args)), out1, rtol=0, atol=0)
    torch.testing.assert_close(cache2.wrap("f", mk(5.0), fingerprint="s5")(
        *torch_args(args)), out2, rtol=0, atol=0)
    jout = JAXCache(str(tmp_path / "jax")).wrap(
        "f", lambda a, b: jnp.tanh(a @ b) * 5.0, fingerprint="s5")(*map(jnp.asarray, args))
    np.testing.assert_allclose(out2.numpy(), np.asarray(jout), atol=1e-5)


def test_cfg_fingerprint_tracks_mutation():
    """_cfg_fingerprint changes with a flag a program bakes in and ignores
    the IO paths and the mesh handle, as the JAX mixin's does."""
    from diffusion_pullback_tpu.experiments._common import DriverCommonMixin as JMixin

    @dataclasses.dataclass
    class Cfg:
        guidance_scale: float = 0.0
        inv_steps: int = 100
        result_folder: str = "./runs/a"
        mesh: object = None

    for mixin in (DriverCommonMixin, JMixin):
        class D(mixin):
            def __init__(self, cfg):
                self.cfg = cfg

        d = D(Cfg())
        fp0 = d._cfg_fingerprint()
        d.cfg.guidance_scale = 7.5
        fp1 = d._cfg_fingerprint()
        assert fp0 != fp1
        d.cfg.result_folder = "./runs/b"
        d.cfg.mesh = object()
        assert d._cfg_fingerprint() == fp1


@dataclasses.dataclass
class _Cfg:
    aot_export: str


class _Driver(DriverCommonMixin):
    def __init__(self, aot_export, events):
        self.cfg = _Cfg(aot_export)
        self.log = type("Log", (), {"log": lambda _, event, **kw: events.append(kw)})()


def _tiny_unet_eps(width):
    """A tiny SD U-Net with 'flash' attention at ``width`` channels in its
    first block, whose self-attention over 32² latents (1024 tokens) runs
    K1, and its ε(z, t, ctx)."""
    cfg = dataclasses.replace(tmodels.sd_tiny_unet(32), attn_impl="flash",
                              block_out_channels=(width, 2 * width))
    unet = tmodels.random_init_(tmodels.UNet2DCondition(cfg), 0).eval().requires_grad_(False)
    rng = np.random.default_rng(1)
    z = torch.from_numpy(rng.standard_normal((1, 4, 32, 32), np.float32))
    ctx = torch.from_numpy(rng.standard_normal((1, 5, 16), np.float32))
    return unet, (lambda z, t, c: unet(z, t, c)), (z, torch.tensor(500.0), ctx)


@pytest.mark.parametrize("width", [8, 64], ids=["narrow", "wide"])
def test_unet_eps_program_reloads_without_weights(width, tmp_path, monkeypatch):
    """The driver's _program of a tiny U-Net's ε: exported with the K1 op in
    its graph, stored in a file smaller than the weights once they
    outweigh the graph (the wide U-Net: the weights are an argument), and
    loaded by a fresh driver, export refused, with the eager output."""
    monkeypatch.setattr(aot, "default_export_dir", lambda: str(tmp_path))
    unet, eps, inputs = _tiny_unet_eps(width)
    eager = eps(*inputs)
    events = []
    with torch.no_grad():
        out = _Driver("on", events)._program("eps", eps, unet)(*inputs)
    torch.testing.assert_close(out, eager, rtol=0, atol=0)
    (path,) = tmp_path.iterdir()
    graph = str(torch.export.load(str(path)).graph)
    assert "dpx.flash_fwd" in graph
    weights = sum(t.numel() * t.element_size() for t in unet.state_dict().values())
    if width == 64:
        assert path.stat().st_size < weights
    with monkeypatch.context() as m:
        m.setattr(torch.export, "export", lambda *a, **k: (_ for _ in ()).throw(
            AssertionError("exported again instead of loading")))
        with torch.no_grad():
            out2 = _Driver("on", events)._program("eps", eps, unet)(*inputs)
    torch.testing.assert_close(out2, eager, rtol=0, atol=0)
    assert [e["status"] for e in events] == ["exported", "loaded"]
    off = _Driver("off", events)._program("eps", eps, unet)
    assert off is eps and events[-1] == {"name": "eps", "status": "eager",
                                         "reason": "aot_export off"}


def test_code_salt_covers_the_kernel_sources():
    """The key's salt reads the port's .py files and its CUDA sources."""
    from diffusion_pullback_tpu_torch.ops import flash_attention as tfa

    assert tfa.SOURCES and all(s.startswith(aot._PKG_DIR) for s in tfa.SOURCES)
    assert len(aot.code_salt()) == 16
    assert aot.default_export_dir() == os.path.join(
        os.path.dirname(aot._PKG_DIR), ".torch_cache", "exports")
