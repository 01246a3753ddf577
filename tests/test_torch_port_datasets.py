"""The port's datasets, config tables and basis loader against the JAX
package's: BenchmarkDataset on a folder written here, HFDataset on a
`datasets` save_to_disk folder, LSUNDataset's RuntimeError without lmdb,
get_dataset's regeneration of the bundled sets into ~/.cache when their
folder is missing, the edit-strength tables and prompts of configs/, and
load_basis of both formats. Runs on the CPU."""

import os

import numpy as np
import pytest
from torch_port_common import one_torch_thread  # noqa: F401

import diffusion_pullback_tpu.utils.datasets as JD
import diffusion_pullback_tpu_torch.utils.datasets as D
from diffusion_pullback_tpu import configs as jconfigs
from diffusion_pullback_tpu.experiments import BasisCache as JBasisCache
from diffusion_pullback_tpu.experiments import load_basis as jload_basis
from diffusion_pullback_tpu_torch import configs
from diffusion_pullback_tpu_torch import main as tmain
from diffusion_pullback_tpu_torch.experiments.cache import load_basis


def _write_images(folder, names, size, seed):
    from PIL import Image

    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for name in names:
        arr = rng.uniform(0, 255, size=size + (3,)).astype(np.uint8)
        Image.fromarray(arr).save(folder / name)


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "test"])
def test_benchmark_dataset_equals_jax(is_train, tmp_path):
    split = "train" if is_train else "test"
    folder = tmp_path / "raw_images" / split / "images"
    _write_images(folder, ["2.png", "0.jpg", "10.png"], (30, 50), 2)
    (folder / "notes.txt").write_text("not an image")
    mine = D.BenchmarkDataset(str(tmp_path), img_size=16, is_train=is_train)
    theirs = JD.BenchmarkDataset(str(tmp_path), img_size=16, is_train=is_train)
    assert mine.files == theirs.files == ["0.jpg", "2.png", "10.png"]
    for i in range(len(mine)):
        x = mine[i]
        assert x.shape == (1, 16, 16, 3) and -1.0 <= x.min() and x.max() <= 1.0
        np.testing.assert_array_equal(x, theirs[i])


def test_hf_dataset_equals_jax(tmp_path):
    hfds = pytest.importorskip("datasets")
    from PIL import Image

    rng = np.random.default_rng(4)
    imgs = [Image.fromarray(rng.uniform(0, 255, size=(40, 56, 3)).astype(np.uint8))
            for _ in range(3)]
    hfds.DatasetDict({"train": hfds.Dataset.from_dict({"image": imgs}).cast_column(
        "image", hfds.Image())}).save_to_disk(str(tmp_path / "flowers"))
    mine = D.HFDataset(str(tmp_path / "flowers"), 16)
    theirs = JD.HFDataset(str(tmp_path / "flowers"), 16)
    assert len(mine) == len(theirs) == 3
    for i in range(3):
        assert mine[i].shape == (1, 16, 16, 3)
        np.testing.assert_allclose(mine[i], theirs[i], atol=1e-6)


def test_lsun_dataset_raises_the_jax_error(tmp_path):
    try:
        import lmdb  # noqa: F401
        pytest.skip("lmdb is installed")
    except ImportError:
        pass
    with pytest.raises(RuntimeError) as mine:
        D.LSUNDataset(str(tmp_path), 16)
    with pytest.raises(RuntimeError) as theirs:
        JD.LSUNDataset(str(tmp_path), 16)
    assert str(mine.value) == str(theirs.value)
    assert isinstance(mine.value.__cause__, ImportError)


@pytest.mark.parametrize("name, n, size", [("CelebA_HQ", 5, 64), ("Examples", 6, 32)])
def test_router_falls_back_to_generated_set(name, n, size, tmp_path, monkeypatch):
    """A checkout without datasets/ still serves the two bundled sets,
    regenerated into ~/.cache, with the JAX router's images."""
    isdir = os.path.isdir
    for module in (D, JD):
        monkeypatch.setattr(module.os.path, "isdir",
                            lambda p: False if "datasets" in p and ".cache" not in p
                            else isdir(p))
    monkeypatch.setenv("HOME", str(tmp_path))
    mine, theirs = D.get_dataset(name, size), JD.get_dataset(name, size)
    assert mine.root.startswith(str(tmp_path / ".cache"))
    assert len(mine) == len(theirs) == n
    assert [os.path.basename(f) for f in mine.files] == [
        os.path.basename(f) for f in theirs.files]
    assert mine[1].shape == (1, size, size, 3)
    np.testing.assert_allclose(mine.load_batch(), theirs.load_batch(), atol=1e-6)
    with pytest.raises(FileNotFoundError):
        D.get_dataset("no_such_set", size)


def test_config_tables_equal_jax():
    assert configs.X_SPACE_GUIDANCE_SCALE_DICT == jconfigs.X_SPACE_GUIDANCE_SCALE_DICT
    assert configs.X_SPACE_EDIT_STEP_SIZE_DICT == jconfigs.X_SPACE_EDIT_STEP_SIZE_DICT
    assert configs.EDIT_PROMPTS == jconfigs.EDIT_PROMPTS
    assert tmain.X_SPACE_GUIDANCE_SCALE_DICT is configs.X_SPACE_GUIDANCE_SCALE_DICT
    args = tmain.parse_args(["--note", "x", "--use_x_space_guidance", "True",
                             "--h_t", "0.6"])
    assert tmain._guidance_scale(args, 1.0) == 2


@pytest.mark.parametrize("native", [True, False], ids=["dpb", "npz"])
def test_load_basis_equals_jax(native, tmp_path):
    rng = np.random.default_rng(5)
    u, s, vT = (rng.normal(size=shape).astype(np.float32)
                for shape in ((12, 3), (3,), (3, 20)))
    cache = JBasisCache(str(tmp_path))
    cache._native = native
    path = cache.save("b", u, s, vT)
    assert path.endswith(".dpb" if native else ".npz")
    for a, b, want in zip(load_basis(path), jload_basis(path), (u, s, vT)):
        np.testing.assert_array_equal(np.asarray(a), want)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
