"""Ring attention in the port (parallel/ring_attention.py, the 'ring' /
'ring_xla' branch of ops/attention.py) against the JAX package's ring on
the 8-device CPU mesh of tests/conftest.py, on the same numpy inputs.

One launch of 4 gloo ranks (tests/torch_port_dist.py) runs every port case;
each test holds a case to its JAX oracle: the math inner and K2's inner
(its plain version on the CPU) at sp 2 and 4 in f32 within 1e-5, bf16 at
the bf16 gate (two ulps of max |ref|), rectangular shapes, odd shards
dropping to the math inner, the dp co-sharding of the batch, the
non-divisible error, and jvp / vjp / vmap through the ring against the
dense math path; a bf16 VAE's single 512-wide head at sp 4 on both
inners. The one-process ring over virtual shards that chip_smoke.py runs
on the card is held to the JAX ring too, in f32 and at that bf16 head."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401
from torch_port_dist import launch, ring_body

from diffusion_pullback_tpu.ops.attention import xla_attention as jxla
from diffusion_pullback_tpu.parallel import make_mesh as jmesh
from diffusion_pullback_tpu.parallel import ring_attention as jring
from diffusion_pullback_tpu_torch.ops.attention import xla_attention
from diffusion_pullback_tpu_torch.parallel import ring_attention as tring


def _qkv(b=2, sq=256, sk=256, h=2, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, s, h, d)).astype(np.float32) for s in (sq, sk, sk))


DATA = {
    "f32": _qkv(), "flash": _qkv(sq=512, sk=512, d=64, seed=1),
    "rect": _qkv(sq=128, sk=512, seed=2), "odd_576": _qkv(sq=576, sk=576, seed=3),
    "odd_254": _qkv(sq=254, sk=254, seed=4), "dp": _qkv(b=4, seed=5),
    "nondiv": _qkv(sq=102, sk=102, seed=6), "ad": _qkv(b=1, sq=64, sk=64, h=1, d=16, seed=7),
    "ad_tangents": tuple(np.stack(t) for t in zip(*[_qkv(b=1, sq=64, sk=64, h=1, d=16,
                                                         seed=8 + i) for i in range(3)])),
    "disp_ring": _qkv(sq=512, sk=512, seed=11), "disp_short": _qkv(seed=12),
    "disp_77": _qkv(sq=256, sk=77, seed=13),
    # one 512-wide head (the VAE mid-block's), run in bf16
    "bf16_512": _qkv(b=1, sq=512, sk=512, h=1, d=512, seed=14),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return launch(ring_body, 4, tmp_path_factory.mktemp("ring"), DATA)


@pytest.fixture(scope="module")
def port(ranks):
    for other in ranks[1:]:  # the output is replicated
        for key, val in ranks[0].items():
            if isinstance(val, np.ndarray):
                np.testing.assert_array_equal(other[key], val, err_msg=key)
    return ranks[0]


def _jax_ring(case, sp, dtype=jnp.float32, **kw):
    q, k, v = (jnp.asarray(a, dtype) for a in DATA[case])
    return np.asarray(jring(q, k, v, mesh=jmesh(("sp",), shape={"sp": sp}), **kw), np.float32)


def _bf16_gate(ref):
    return 2 * 2.0 ** -7 * 2.0 ** math.floor(math.log2(np.abs(ref).max()))


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("inner", ["xla", "flash"])
def test_ring_matches_jax(port, sp, inner):
    case = "f32" if inner == "xla" else "flash"
    ref = _jax_ring(case, sp, inner=inner, interpret=True)
    np.testing.assert_allclose(port[f"{inner}_sp{sp}"], ref, atol=1e-5)
    np.testing.assert_allclose(port[f"{inner}_sp{sp}"], np.asarray(jxla(*DATA[case])),
                               atol=2e-5)


def test_bf16_ring_at_the_bf16_gate(port):
    ref = _jax_ring("f32", 2, jnp.bfloat16)
    assert np.abs(port["bf16_sp2"] - ref).max() <= _bf16_gate(ref)


@pytest.mark.parametrize("inner", ["xla", "flash"])
def test_bf16_d512_ring_at_the_bf16_gate(port, inner):
    """The VAE's single 512-wide head in bf16 over the 4 gloo ranks: the
    default inner (the math path on the CPU, as in JAX) and K2's (its plain
    version on the CPU) against the JAX ring with the same inner."""
    kw = dict(inner="flash", interpret=True) if inner == "flash" else {}
    ref = _jax_ring("bf16_512", 4, jnp.bfloat16, **kw)
    got = port[f"bf16_512_{inner}_sp4"]
    assert got.shape == ref.shape and np.abs(got - ref).max() <= _bf16_gate(ref)


def test_rectangular(port):
    np.testing.assert_allclose(port["rect_sp4"], _jax_ring("rect", 4), atol=1e-5)


@pytest.mark.parametrize("sq", [576, 254])
def test_flash_inner_odd_shards(port, sq):
    """576/2 = 288 rows run K2 at a 288 block; 254/2 = 127 rows have no
    block of 128 or more and take the math inner, as in JAX."""
    from diffusion_pullback_tpu_torch.parallel.ring_attention import choose_inner

    ref = _jax_ring(f"odd_{sq}", 2, inner="flash", interpret=True)
    np.testing.assert_allclose(port[f"odd_{sq}"], ref, atol=1e-5)
    q = torch.zeros(1)
    assert choose_inner("flash", q, sq // 2, sq // 2) == ("flash" if sq == 576 else "xla")


def test_dp_co_sharding(port):
    q, k, v = (jnp.asarray(a) for a in DATA["dp"])
    ref = jring(q, k, v, mesh=jmesh(("dp", "sp"), shape={"dp": 2, "sp": 2}))
    np.testing.assert_allclose(port["dp_sp"], np.asarray(ref), atol=1e-5)


def test_non_divisible_raises(port):
    assert "not divisible by sp=4" in port["nondiv"]


def test_both_ad_modes_under_vmap_match_the_dense_math(port):
    q, k, v = (torch.from_numpy(a) for a in DATA["ad"])
    tq, tk, tv = (torch.from_numpy(a) for a in DATA["ad_tangents"])
    jvp1 = lambda a, b, c: torch.func.jvp(xla_attention, (q, k, v), (a, b, c))[1]
    _, pull = torch.func.vjp(xla_attention, q, k, v)
    close = lambda a, b: np.testing.assert_allclose(a, b.detach().numpy(), atol=3e-5)
    close(port["ad_jvp"], jvp1(tq[0], tk[0], tv[0]))
    close(port["ad_vmap_jvp"], torch.func.vmap(jvp1)(tq, tk, tv))
    close(port["ad_vjp"], torch.stack(pull(tq[0])))
    close(port["ad_vmap_vjp"], torch.stack(torch.func.vmap(pull)(tq)))
    # and the JAX ring's jvp
    jr = lambda *a: jring(*a, mesh=jmesh(("sp",), shape={"sp": 4}), inner="xla")
    _, ref = jax.jvp(jr, tuple(map(jnp.asarray, DATA["ad"])),
                     tuple(jnp.asarray(t[0]) for t in DATA["ad_tangents"]))
    np.testing.assert_allclose(port["ad_jvp"], np.asarray(ref), atol=3e-5)


@pytest.mark.parametrize("case", ["disp_ring", "disp_short", "disp_77"])
def test_dispatcher_rings_or_falls_back(port, case):
    """attention(impl='ring') rings over the published sp 4 mesh where the
    shards keep 128 rows (512 tokens) and takes the dense path below that
    (256 tokens) and on a 77-token context, as the JAX dispatcher."""
    ref = np.asarray(jxla(*map(jnp.asarray, DATA[case])))
    np.testing.assert_allclose(port[case], ref, atol=2e-5)
    if case == "disp_ring":
        np.testing.assert_allclose(port["disp_ring_xla"], ref, atol=2e-5)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("inner", ["xla", "flash"])
def test_virtual_ring_matches_jax(n, inner):
    """The per-rank loop over n virtual shards in one process, the K/V
    shards handed in ring order (chip_smoke.py's phase 15 (a) on the
    card), equals the JAX ring at sp n."""
    from diffusion_pullback_tpu_torch.parallel.ring_attention import ring_attention_virtual

    out = ring_attention_virtual(*map(torch.from_numpy, DATA["flash"]), n, inner=inner)
    ref = _jax_ring("flash", n, inner=inner, interpret=True)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_virtual_ring_bf16_d512_matches_jax(n, monkeypatch):
    """The virtual ring with K2's inner in bf16 at D = 512 (the shards of a
    bf16 VAE's head that chip_smoke.py's phase 15 runs on 'mma_bf16'): on
    the CPU the n² K2 calls run its plain version, each at the shard shape;
    the result equals the JAX ring (Pallas K2 in interpret mode) at the
    bf16 gate."""
    from diffusion_pullback_tpu_torch.ops import flash_attention as tfa
    from diffusion_pullback_tpu_torch.parallel.ring_attention import ring_attention_virtual

    shapes, plain = [], tfa.flash_forward_lse_plain
    monkeypatch.setattr(tfa, "flash_forward_lse_plain", lambda q, *a, **kw: (
        shapes.append((tuple(q.shape), q.dtype)), plain(q, *a, **kw))[1])
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in DATA["bf16_512"])
    out = ring_attention_virtual(q, k, v, n, inner="flash")
    assert shapes == [((1, 512 // n, 512), torch.bfloat16)] * (n * n)
    ref = _jax_ring("bf16_512", n, jnp.bfloat16, inner="flash", interpret=True)
    assert out.dtype == torch.bfloat16
    assert np.abs(out.float().numpy() - ref).max() <= _bf16_gate(ref)


def test_ring_needs_a_mesh():
    with pytest.raises(ValueError, match="needs a mesh"):
        tring(*map(torch.from_numpy, DATA["f32"]))
