"""Tiny cells for the benchmark's CPU tests: the harness, the port and
the reference at widths a test run holds, on one torch thread."""

import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_CONFIG = {
    "name": "tiny",
    "unet_dtype": "float32", "vae_dtype": "float32", "text_dtype": "float32",
    "attn_impl": "flash",
    "unet": {"sample_size": 16, "in_channels": 4, "out_channels": 4,
             "block_out_channels": [16, 32],
             "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
             "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"],
             "layers_per_block": 1, "attention_head_dim": [2, 4],
             "cross_attention_dim": 16, "use_linear_projection": True,
             "norm_num_groups": 4, "norm_eps": 1e-5, "flip_sin_to_cos": True,
             "freq_shift": 0},
    "vae": {"sample_size": 32, "in_channels": 3, "out_channels": 3,
            "latent_channels": 4, "block_out_channels": [8, 16], "layers_per_block": 1,
            "norm_num_groups": 4, "scaling_factor": 0.18215},
    "text_encoder": {"vocab_size": 128, "hidden_size": 16, "intermediate_size": 32,
                     "num_hidden_layers": 2, "num_attention_heads": 2,
                     "max_position_embeddings": 8, "hidden_act": "gelu"},
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_cell():
    """A spec.Cell of the SD 2.1-base harvest's traffic at rank 4 on the
    tiny U-Net in float32, with that cell's limits."""
    from port_bench.harness import spec

    real = spec.load_cell("sd21-base.harvest-r50", ROOT)
    traffic = dict(real.traffic, pca_rank=4, probe_chunk=2)
    return spec.Cell(workload=real.workload, config=copy.deepcopy(TINY_CONFIG),
                     traffic=traffic, end_to_end=real.end_to_end,
                     per_layer=real.per_layer, limits=real.limits)


def bench_json():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)
