"""ops/fwd_tc_variants.py builds each design variant of the bf16 and the
f32 forward and ops/bwd_tc_variants.py each variant of the bf16 tangent
and of the f32 tangent and backward, by replacing a text of the kernel
sources. Each such text must stand in its file exactly once, so that a
variant still builds the one change it names after the sources move on.
ops/bwd_tc_variants.py (the tangent and the backward as built against an
earlier tree's csrc/) reads registers and spills per K3/K4/K5 instance
from nvcc's -Xptxas -v output (an earlier tree's D = 64-only kernels too,
for its --parent build), and per block shape of the f32 tangent's and
backward's; ops/fwd_tc_variants.py those of the f32 rows forward and of
the bf16 D = 512 forward. Runs on the CPU: nothing is compiled."""

import os

import pytest

from diffusion_pullback_tpu_torch.ops import bwd_tc_variants, fwd_tc_variants

# (tool, variant, file, old text); the f32 forward's under "fwd_tc_variants f32"
EDITS = [(tool, name, file, old)
         for tool, variants in (("fwd_tc_variants", fwd_tc_variants.VARIANTS["bf16"]),
                                ("fwd_tc_variants f32", fwd_tc_variants.VARIANTS["f32"]),
                                ("bwd_tc_variants", bwd_tc_variants.VARIANTS["bf16"]),
                                ("bwd_tc_variants f32", bwd_tc_variants.VARIANTS["f32"]))
         for name, edits in variants.items() for file, old, _ in edits]


@pytest.mark.parametrize("tool, variant, file, old", EDITS,
                         ids=[f"{t}:{v}:{f}" for t, v, f, _ in EDITS])
def test_variant_edit_stands_once_in_its_source(tool, variant, file, old):
    with open(os.path.join(fwd_tc_variants.CSRC, file)) as f:
        assert f.read().count(old) == 1, (tool, variant, file, old)


@pytest.mark.parametrize("file", ["hopper.cuh", "flash_fwd_tc.cu"])
def test_variant_whose_text_is_gone_is_refused_before_nvcc(file, tmp_path):
    """A copy of the sources whose edit no longer finds its text is refused
    by name, before any compile (so this runs without nvcc)."""
    with pytest.raises(RuntimeError, match=f"'stale': 'no such text' is not in {file}"):
        fwd_tc_variants.build("stale", [(file, "no such text", "")], out=str(tmp_path))
    assert sorted(os.listdir(tmp_path / "stale")) == sorted(os.listdir(fwd_tc_variants.CSRC))


def test_registers_are_read_per_kernel_and_head_dim():
    log = """\
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__1_15_flash_bwd_tc_cu_222flash_dkv_wgmma_kernelILi160EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__1_15_flash_bwd_tc_cu_222flash_dkv_wgmma_kernelILi160EEEv14CUtensorMap_st
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__1_15_flash_fwd_tc_cu_222flash_fwd_wgmma_kernelILi40ELb1EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Used 95 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__1_15_flash_bwd_tc_cu_221flash_dq_wgmma_kernelILi40EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__1_15_flash_bwd_tc_cu_221flash_dq_wgmma_kernelILi40EEEv14CUtensorMap_st
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 110 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__1_15_flash_bwd_tc_cu_222flash_dkv_wgmma_kernelE14CUtensorMap_stS0_S0_S0_PKfS2_P13__nv_bfloat16S4_iiif' for 'sm_90a'
ptxas info    : Used 166 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__1_15_flash_jvp_tc_cu_5b1f2a2c26flash_tangent_wgmma_kernelILi80EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__1_15_flash_jvp_tc_cu_5b1f2a2c26flash_tangent_wgmma_kernelILi80EEEv14CUtensorMap_st
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__1_15_flash_jvp_tc_cu_5b1f2a2c26flash_tangent_wgmma_kernelE14CUtensorMap_stS0_S0_S0_S0_S0_PK13__nv_bfloat16PKfPS1_iiif' for 'sm_90a'
ptxas info    : Used 151 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__1_11_flash_jvp_cu_5b1f2a2c20flash_tangent_kernelIN5flash4TileILi64ELi64ELi64ELi16EEEEvPKfS5_S5_S5_S5_S5_S5_S5_Pfiiif' for 'sm_90a'
ptxas info    : Used 128 registers, used 1 barriers
"""
    assert bwd_tc_variants.registers(log) == {("K5", "wgmma", 160, 64): (255, 8, 12),
                                              ("K4", "wgmma", 40, 64): (110, 0, 0),
                                              ("K5", "wgmma", 64, 64): (166, 0, 0),
                                              ("K3", "wgmma", 80, 64): (168, 0, 0),
                                              ("K3", "wgmma", 64, 64): (151, 0, 0)}


def test_tf32x3_backward_registers_are_read_per_block_shape():
    """ops/bwd_tc_variants.py --dtype f32 reads registers and spills per
    tf32x3 K4/K5 instance, keyed (kernel, design, D, rows of a block) from
    its template arguments (K4: D, m-tiles a warp of 4 warps; K5: D, row
    groups, m-tiles a warp); the forward's rows kernels are skipped."""
    log = """\
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__0f1e2d3c_22_flash_bwd_tf32_rows_cu_5a6b7c8d25flash_dq_tf32_rows_kernelILi80ELi2EEEvPKfS2_S2_S2_S2_S2_Pfiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__0f1e2d3c_22_flash_bwd_tf32_rows_cu_5a6b7c8d25flash_dq_tf32_rows_kernelILi80ELi2EEEvPKfS2_S2_S2_S2_S2_Pfiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 198 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__d96ef202_22_flash_fwd_tf32_rows_cu_22685d6f26flash_fwd_tf32_rows_kernelILi64ELi4ELi2EEEvPKfS2_S2_PfS3_iif' for 'sm_90a'
ptxas info    : Used 200 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__0f1e2d3c_22_flash_bwd_tf32_rows_cu_5a6b7c8d26flash_dkv_tf32_rows_kernelILi160ELi2ELi1EEEvPKfS2_S2_S2_S2_S2_PfS3_iiif' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__0f1e2d3c_22_flash_bwd_tf32_rows_cu_5a6b7c8d26flash_dkv_tf32_rows_kernelILi160ELi2ELi1EEEvPKfS2_S2_S2_S2_S2_PfS3_iiif
    0 bytes stack frame, 40 bytes spill stores, 40 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
"""
    assert bwd_tc_variants.registers(log) == {("K4", "tf32x3", 80, 128): (198, 0, 0),
                                              ("K5", "tf32x3", 160, 32): (255, 40, 40)}


def test_rows_kernel_registers_are_read_per_block_shape():
    """ops/fwd_tc_variants.py reads registers and spills per f32 rows-kernel
    instance, keyed (D, rows of a block, rows of a warp) from its template
    arguments (D, row groups, m-tiles a warp); other kernels are skipped."""
    log = """\
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__d96ef202_22_flash_fwd_tf32_rows_cu_22685d6f26flash_fwd_tf32_rows_kernelILi64ELi4ELi2EEEvPKfS2_S2_PfS3_iif' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__d96ef202_22_flash_fwd_tf32_rows_cu_22685d6f26flash_fwd_tf32_rows_kernelILi64ELi4ELi2EEEvPKfS2_S2_PfS3_iif
    0 bytes stack frame, 76 bytes spill stores, 88 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__1_15_flash_fwd_tc_cu_222flash_fwd_wgmma_kernelILi40ELb1EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Used 95 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__d96ef202_22_flash_fwd_tf32_rows_cu_22685d6f26flash_fwd_tf32_rows_kernelILi160ELi2ELi1EEEvPKfS2_S2_PfS3_iif' for 'sm_90a'
ptxas info    : Used 173 registers, used 1 barriers
"""
    assert fwd_tc_variants.registers(log) == {(64, 128, 32): (255, 76, 88),
                                              (160, 32, 16): (173, 0, 0)}


def test_tf32x3_tangent_and_bf16_d512_registers_are_read():
    """The f32 tangent's rows kernel (K3, csrc/flash_jvp_tf32_rows.cu) is
    read by ops/bwd_tc_variants.py keyed (kernel, design, D, rows of a
    block) from its template arguments (D, m-tiles a warp of 4 warps), and
    the bf16 D = 512 forward (csrc/flash_fwd_mma_bf16.cu) by
    ops/fwd_tc_variants.py as (512, 32 rows, 32 a warp)."""
    log = """\
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__7a1b2c3d_22_flash_jvp_tf32_rows_cu_1e2f3a4b30flash_tangent_tf32_rows_kernelILi80ELi2EEEvPKfS2_S2_S2_S2_S2_S2_S2_Pfiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__7a1b2c3d_22_flash_jvp_tf32_rows_cu_1e2f3a4b30flash_tangent_tf32_rows_kernelILi80ELi2EEEvPKfS2_S2_S2_S2_S2_S2_S2_Pfiiif
    0 bytes stack frame, 16 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__7a1b2c3d_22_flash_jvp_tf32_rows_cu_1e2f3a4b30flash_tangent_tf32_rows_kernelILi160ELi1EEEvPKfS2_S2_S2_S2_S2_S2_S2_Pfiiif' for 'sm_90a'
ptxas info    : Used 210 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__5e6f7a8b_21_flash_fwd_mma_bf16_cu_9c0d1e2f25flash_fwd_mma_bf16_kernelEPK13__nv_bfloat16S2_S2_PS0_iif' for 'sm_90a'
ptxas info    : Used 168 registers, used 1 barriers
"""
    assert bwd_tc_variants.registers(log) == {("K3", "tf32x3", 80, 128): (255, 16, 24),
                                              ("K3", "tf32x3", 160, 64): (210, 0, 0)}
    assert fwd_tc_variants.registers(log) == {(512, 32, 32): (168, 0, 0)}
