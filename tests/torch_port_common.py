"""Shared helpers of the tests/test_torch_port_*.py files."""

import jax
import numpy as np
import pytest
import torch


def flax_params(module, *example_args, seed=0):
    """A Flax param tree for ``module`` with seeded numpy values, built from
    the shapes alone (jax.eval_shape, no compile): LeCun-normal kernels and
    embeddings, norm scales 1 + 0.1·N(0,1), biases 0.1·N(0,1) — so every
    bias and scale is nonzero and its mapping into the port is exercised."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.key(0), *example_args)

    def leaf(path, s):
        name = path[-1].key
        z = rng.normal(size=s.shape).astype(np.float32)
        if name == "kernel":
            return z * np.float32(np.prod(s.shape[:-1]) ** -0.5)
        if name == "embedding":
            return z * np.float32(s.shape[-1] ** -0.5)
        if name == "scale":
            return 1.0 + 0.1 * z
        return 0.1 * z

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).detach().numpy()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for a test module's small tensors: the tier-1 run
    puts six test processes on the CPU's cores, and torch's per-op thread
    team, spinning at every tiny op, slows all of them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
