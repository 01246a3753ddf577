"""The plain reference against the port at tiny widths on the CPU: the
mid-tap encoder and the rank-r pullback agree in float32, and the control
(the reference in the format below the configuration's) fails."""

import pytest
import torch

from port_bench.harness import check, system, weights
from port_bench.reference.arith import LOWER
from port_bench.reference.unet import layout, mid_tap_map


def test_mid_tap_matches_port(tiny_cell, tmp_path):
    from port_bench.reference.arith import Exact, Rounded
    from diffusion_pullback_tpu_torch.models import TapPoint

    cfg, seed = tiny_cell.config, 5
    sys_ = system.System(cfg, tiny_cell.traffic, seed, "cpu", str(tmp_path))
    z = system.draw_latent(cfg, seed, 0, "cpu")
    t = torch.tensor(system.unit_t(tiny_cell.traffic, seed, 0))
    ctx = system.draw_context(cfg, seed, "cpu")
    with torch.no_grad():
        h = sys_.edit.unet.encode(z.permute(0, 3, 1, 2), t, ctx, TapPoint("mid", 0))
        P = weights.draw(layout(cfg["unet"]), seed, system.STREAM_UNET, "cpu", torch.float32)
        ref = mid_tap_map(P, cfg["unet"], Exact(), t, ctx)(z)
        low = mid_tap_map(P, cfg["unet"], Rounded("bfloat16"), t, ctx)(z)
    gap = lambda a: float((a - ref).norm() / ref.norm())
    assert gap(h.permute(0, 2, 3, 1)) < 1e-4
    assert gap(low) > 1e-3


def test_pullback_matches_port_and_control_fails(tiny_cell, tmp_path):
    seed = 11
    sys_ = system.System(tiny_cell.config, tiny_cell.traffic, seed, "cpu", str(tmp_path))
    got = system.read_basis(sys_.unit(0))
    ref = check.reference_basis(tiny_cell.config, tiny_cell.traffic, seed, 0, "cpu")
    program = check.basis_numbers(got, ref)
    ok, _ = check.verdict(program, tiny_cell.limits)
    assert ok, program
    assert program["sigma"] < 1e-4 and program["v_subspace"] < 1e-6, program
    fmt = LOWER[tiny_cell.config["unet_dtype"]]
    control = check.basis_numbers(
        check.reference_basis(tiny_cell.config, tiny_cell.traffic, seed, 0, "cpu", fmt), ref)
    assert control["sigma"] > 30 * program["sigma"], (control, program)
    assert control["v_subspace"] > 1e-4, control


@pytest.mark.parametrize("fmt", ["bfloat16", "fp8"])
def test_rounding_reaches_tangents(fmt):
    """The control rounds a pullback's tangents as it rounds the values."""
    from torch.func import jvp

    from port_bench.reference.arith import Rounded

    A = Rounded(fmt)
    x = torch.linspace(-1.0, 1.0, 97) * 0.7
    tx = torch.linspace(0.3, 1.3, 97) * 0.37
    y, ty = jvp(A.q, (x,), (tx,))
    assert not torch.equal(y, x) and not torch.equal(ty, tx)
    assert torch.allclose(ty, A.q(tx))


def test_weights_repeat_and_follow_layout():
    lay = {"a.weight": (8, 4, 3, 3), "a.bias": (8,), "n.weight": (4,), "e.embedding.weight": (5, 6)}
    one = weights.draw(lay, 2 ** 31 + 7, 0, "cpu", torch.bfloat16)
    two = weights.draw(lay, 2 ** 31 + 7, 0, "cpu", torch.bfloat16)
    assert all(torch.equal(one[k], two[k]) for k in lay)
    assert all(tuple(one[k].shape) == s and one[k].dtype == torch.bfloat16 for k, s in lay.items())
    assert torch.count_nonzero(one["a.bias"]) == 0 and torch.all(one["n.weight"] == 1)
    std = float(one["a.weight"].float().std())
    assert 0.5 / 6 < std < 2 / 6
    assert not torch.equal(weights.draw(lay, 3, 0, "cpu", torch.float32)["a.weight"],
                           weights.draw(lay, 3, 1, "cpu", torch.float32)["a.weight"])
