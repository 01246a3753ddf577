"""h-space guidance of the port's uncond driver against the JAX package's
on the CPU at f32: on ddpm_tiny(16) and on the 64 px UNetADM of
torch_port_common.ADM_TINY_1024 (learned σ, so the walk takes the ε half
of the channel axis 1 in NCHW; its 32² level self-attends over 1024
tokens, so the port's sampling runs K1's plain version), shared weights
carried by load_flax_params, η = 0 (no boosting noise). The JAX driver
computes the basis and the PNGs; the port edits from a copy of the same
basis file, so the û_k it reshapes NHWC → NCHW are the JAX run's own.
Gate: the same PNG names, each PNG within one uint8 level of the JAX one.
(Parallel transport: tests/test_torch_port_uncond_transport.py.)"""

import pytest
from torch_port_common import (  # noqa: F401
    adm_driver_pair,
    copy_bases,
    ddpm_driver_pair,
    one_torch_thread,
    plain_shapes,
    same_pngs,
    uncond_same_start,
)

CFG = dict(dataset_name="noise", for_steps=8, inv_steps=8, edit_t=0.6, pca_rank=2,
           pullback_min_iter=0, pullback_max_iter=1, pullback_atol=0.0,
           x_space_guidance_num_step=2, x_space_guidance_scale=0.5, vis_num=2,
           vis_num_pc=1, use_performance_boosting=False)


def _pair(kind, root):
    if kind == "ddpm":
        return ddpm_driver_pair(root, CFG)
    return adm_driver_pair(root, CFG)


@pytest.mark.parametrize("kind,size", [("ddpm", 16), ("adm", 64)])
def test_h_space_guidance_matches_jax(tmp_path, monkeypatch, plain_shapes, kind, size):
    """One direction pair at scale 0.7 (named with its float repr): per
    micro-step one encoder pass of both directions and one decode of the
    four [h; h + δ·û] rows."""
    jdrv, tdrv = _pair(kind, tmp_path)
    uncond_same_start(monkeypatch, jdrv, tdrv, rank=2)
    jnames = jdrv.run_edit_h_space_guidance(idx=1, scale=0.7)
    copy_bases(jdrv, tdrv)
    tnames = tdrv.run_edit_h_space_guidance(idx=1, scale=0.7)
    assert tnames == jnames == [
        f"Edit_h_space-noise_1-edit_0.6T-mid-block_0-scale_0.7-pc_000_{s}"
        for s in ("pos", "neg")]
    same_pngs(jdrv, tdrv, tnames, size)
    k1 = plain_shapes["flash_forward_plain"]
    assert not plain_shapes["flash_tangent_plain"]     # the basis came from the cache
    if kind == "adm":
        # the walk: the encoder at the 2 directions' rows, the decode of the
        # [h; h + δ·û] pair at 4 (one head of 64 over 1024 tokens)
        assert (2, 2, 1024) in k1 and (4, 4, 1024) in k1
    else:
        assert not k1
    # a second call finds every PNG and walks nothing
    assert tdrv.run_edit_h_space_guidance(idx=1, scale=0.7) == tnames


def test_h_space_scale_default_and_pc_clamp(tmp_path, monkeypatch):
    """scale defaults to h_space_guidance_scale, else x_space_guidance_scale;
    vis_num_pc beyond the basis' rank is clamped, as the JAX driver logs."""
    jdrv, tdrv = _pair("ddpm", tmp_path)
    uncond_same_start(monkeypatch, jdrv, tdrv, rank=2)
    events = []
    monkeypatch.setattr(tdrv.log, "log", lambda e, **kw: events.append((e, kw)))
    names = tdrv.run_edit_h_space_guidance(idx=0, vis_num_pc=3)
    assert len(names) == 4 and all("-scale_0.5-" in n for n in names)
    assert ("vis_num_pc_clamped", {"requested": 3, "available": 2}) in events
    tdrv.cfg.h_space_guidance_scale = 2.0
    assert tdrv.run_edit_h_space_guidance(idx=0)[0].endswith("-scale_2.0-pc_000_pos")
