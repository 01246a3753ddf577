"""The port's mesh (parallel/mesh.py), the CLI's --mesh_axes and
--attn_impl ring (main.py's build_mesh, mesh_spec and preset), and the
differentiable collectives (parallel/collectives.py).

mesh_shape_for is held to the JAX function; build_mesh's grammar to the
JAX CLI's (main.py:33-60) on a 4-rank gloo launch
(tests/torch_port_dist.py); a shape that does not cover the ranks raises
(the port's documented departure from the JAX device prefix); each
collective equals its single-process meaning (a chunk, a concatenation,
a sum of the ranks' partials, a roll of the ring) in value, under jvp,
vjp and vmap of both."""

import numpy as np
import pytest
from torch_port_common import one_torch_thread  # noqa: F401
from torch_port_dist import launch, mesh_body

from diffusion_pullback_tpu.parallel import mesh_shape_for as jshape_for
from diffusion_pullback_tpu_torch import main as tmain
from diffusion_pullback_tpu_torch.parallel import mesh_shape_for

SPECS = ["dp:2,probe:2", "probe", "dp,probe", "dp:4", "sp:4", "", "dp:2,tp:2",
         "dp:1,fsdp:4"]


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 32, 12])
@pytest.mark.parametrize("axes", [("dp",), ("dp", "probe"), ("dp", "probe", "tp"),
                                  ("dp", "fsdp")])
def test_mesh_shape_for_matches_jax(n, axes):
    assert mesh_shape_for(n, axes) == jshape_for(n, axes)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rng = np.random.default_rng(0)
    return launch(mesh_body, 4, tmp_path_factory.mktemp("mesh"), dict(
        specs=SPECS, x=rng.normal(size=(2, 6, 4)).astype(np.float32),
        ts=rng.normal(size=(3, 2, 6, 4)).astype(np.float32)))


def _jax_shape(spec, n=4):
    """The JAX CLI's parse of --mesh_axes over n devices (main.py:33-60)."""
    if not spec:
        return None
    axes, shape = [], {}
    for part in spec.split(","):
        if ":" in part:
            a, k = part.split(":")
            axes.append(a)
            shape[a] = int(k)
        else:
            axes.append(part)
    return shape if len(shape) == len(axes) else jshape_for(n, axes)


@pytest.mark.parametrize("spec", SPECS)
def test_build_mesh_grammar_matches_the_jax_cli(ranks, spec):
    for r in ranks:
        assert r[spec] == _jax_shape(spec)


def test_mesh_spec():
    assert tmain.mesh_spec("dp:2, probe") == (("dp", "probe"), {"dp": 2})
    assert tmain.mesh_spec("") == ((), {})


def test_a_shape_short_of_the_world_raises(ranks):
    """The JAX make_mesh takes a device prefix; a torch run starts the
    ranks of its mesh, so 'tp:2' at 4 ranks raises."""
    assert all("does not cover 4 ranks" in r["prefix"] for r in ranks)


def test_agreed_is_rank_zeros(ranks):
    assert [r["agreed"] for r in ranks] == [(True, False)] * 4


@pytest.mark.parametrize("op", ["gather", "region", "ring"])
def test_collectives_under_jvp_vjp_and_vmap(ranks, op):
    for r in ranks:
        assert r[op] < 1e-5, (op, r[op])


@pytest.mark.parametrize("argv, impl", [
    (["--mesh_axes", "sp:4"], "ring"), (["--mesh_axes", "dp:2,sp:2"], "ring"),
    (["--mesh_axes", "dp:4"], "auto"), (["--mesh_axes", "sp:4", "--attn_impl", "xla"], "xla"),
    (["--attn_impl", "ring"], "ring")])
def test_preset_auto_is_ring_with_an_sp_axis(argv, impl, tmp_path, monkeypatch, capsys):
    """As the JAX preset (utils/config.py:329-338)."""
    from diffusion_pullback_tpu.utils.config import parse_args as jparse_args
    from diffusion_pullback_tpu.utils.config import preset as jpreset

    monkeypatch.chdir(tmp_path)
    argv = ["--note", "x", "--model_name", "stabilityai/stable-diffusion-2-1-base"] + argv
    args = tmain.parse_args(argv)
    tmain.check_preset(args)
    assert args.attn_impl == impl
    if impl == "ring" and "--attn_impl" not in argv:
        assert "[preset] --attn_impl auto -> ring (sp mesh axis)" in capsys.readouterr().out
        assert jpreset(jparse_args(argv)).attn_impl == "ring"
