"""The port's binding of the native image and basis library
(diffusion_pullback_tpu_torch/utils/native.py) against the JAX package's
(diffusion_pullback_tpu/utils/native.py): tests/test_native.py's checks on
the port's functions, each output held to the JAX binding's on the same
images, ImgDataset.load_batch against JAX's and against __getitem__, and
.dpb basis files written by either package read by the other bit for bit.

The port builds its own library from native/*.cpp into its .build folder;
the JAX package loads native/libdpximg.so, built on another machine. Both
take -march=native, so the float results are held within 1e-6 (a
contraction into FMA may differ in the last bit) and uint8 grids within one
level. Runs on the CPU."""

import os

import numpy as np
import pytest
from torch_port_common import one_torch_thread  # noqa: F401

from diffusion_pullback_tpu.experiments import BasisCache as JBasisCache
from diffusion_pullback_tpu.utils import native as jnative
from diffusion_pullback_tpu.utils.datasets import ImgDataset as JImgDataset
from diffusion_pullback_tpu_torch.experiments import BasisCache
from diffusion_pullback_tpu_torch.experiments.cache import load_basis
from diffusion_pullback_tpu_torch.utils import native
from diffusion_pullback_tpu_torch.utils.datasets import ImgDataset
from diffusion_pullback_tpu_torch.utils.images import to_uint8

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("g++ cannot build the native library here")
    return lib


def test_builds_into_the_port_and_leaves_native_alone(lib):
    assert lib.dpx_version() >= 2
    assert os.path.dirname(lib._name) == native.BUILD_DIR
    assert not lib._name.startswith(os.path.join(REPO, "native"))
    assert native.build() == lib._name  # keyed: a second build reuses it


def test_crop_resize_normalize_range_and_shape(lib):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(77, 131, 3), dtype=np.uint8)
    out = native.crop_resize_normalize(img, 32)
    assert out.shape == (32, 32, 3) and out.dtype == np.float32
    assert out.min() >= -1.0 and out.max() <= 1.0
    np.testing.assert_allclose(out, jnative.crop_resize_normalize(img, 32), atol=1e-6)
    sq = rng.integers(0, 256, size=(16, 16, 3), dtype=np.uint8)
    np.testing.assert_allclose(native.crop_resize_normalize(sq, 16),
                               sq.astype(np.float32) / 255.0 * 2 - 1, atol=1e-5)


def test_crop_is_centered(lib):
    img = np.zeros((64, 128, 3), np.uint8)
    img[:, 32:96] = 255
    out = native.crop_resize_normalize(img, 8)
    np.testing.assert_allclose(out, np.ones_like(out), atol=1e-5)


@pytest.mark.parametrize("size, out_size", [(16, 32), (64, 32)], ids=["up", "down"])
def test_resize_equals_jax_and_is_near_pil(lib, size, out_size):
    from PIL import Image

    rng = np.random.default_rng(1 if size == 16 else 3)
    img = rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
    out = native.crop_resize_normalize(img, out_size)
    np.testing.assert_allclose(out, jnative.crop_resize_normalize(img, out_size),
                               atol=1e-6)
    ref = np.asarray(Image.fromarray(img).resize((out_size, out_size), Image.BILINEAR),
                     np.float32) / 255.0 * 2 - 1
    # PIL's bilinear downsample averages over an area, the library samples
    # at points: close in the mean, not equal
    assert np.abs(out - ref).mean() < (0.02 if size < out_size else 0.2)


def test_batch_to_grid_equals_jax(lib):
    rng = np.random.default_rng(2)
    batch = rng.uniform(-1.2, 1.2, size=(5, 8, 8, 3)).astype(np.float32)
    grid = native.batch_to_grid(batch, nrow=2)
    assert grid.shape == (3 * 8, 2 * 8, 3)
    assert np.abs(grid.astype(int) - jnative.batch_to_grid(batch, nrow=2)).max() <= 1
    arr = to_uint8(batch)
    np.testing.assert_allclose(grid[:8, :8], arr[0], atol=1)
    np.testing.assert_allclose(grid[16:24, :8], arr[4], atol=1)
    assert grid[16:24, 8:16].max() == 0


@pytest.fixture
def images(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, size=(91, 67, 3)).astype(np.uint8)
    png, jpg = str(tmp_path / "a.png"), str(tmp_path / "b.jpg")
    Image.fromarray(img).save(png)
    Image.fromarray(img).save(jpg, quality=95)
    return png, jpg


def test_native_decode_equals_jax(lib, images, tmp_path):
    from PIL import Image

    if not (native.has_codecs() and jnative.has_codecs()):
        pytest.skip("a native library without the jpeg / png codecs")
    for p in images:
        nat = native.decode_crop_resize(p, 32)
        assert nat is not None and nat.shape == (32, 32, 3)
        np.testing.assert_allclose(nat, jnative.decode_crop_resize(p, 32), atol=1e-6)
        pil = native.crop_resize_normalize(np.asarray(Image.open(p).convert("RGB")), 32)
        np.testing.assert_allclose(nat, pil, atol=2 / 255.0, err_msg=p)
    batch, ok = native.decode_batch(list(images) * 8, 32)
    jbatch, jok = jnative.decode_batch(list(images) * 8, 32)
    assert batch.shape == (16, 32, 32, 3) and ok.all() and jok.all()
    np.testing.assert_allclose(batch, jbatch, atol=1e-6)
    bad = str(tmp_path / "nope.jpg")
    with open(bad, "wb") as f:
        f.write(b"\xff\xd8garbage")
    assert native.decode_batch([images[0], bad], 32)[1].tolist() == [True, False]


@pytest.mark.parametrize("folder", ["written", "examples"])
def test_img_dataset_load_batch_equals_jax(lib, folder, tmp_path):
    from PIL import Image

    if folder == "written":
        rng = np.random.default_rng(1)
        for i in range(4):
            Image.fromarray(rng.uniform(0, 255, size=(40, 40, 3)).astype(np.uint8)
                            ).save(tmp_path / f"{i}.png")
        root, size = str(tmp_path), 16
    else:
        root, size = os.path.join(REPO, "datasets", "examples"), 64
    ds = ImgDataset(root, size)
    batch = ds.load_batch()
    assert batch.shape == (len(ds), size, size, 3)
    np.testing.assert_allclose(batch, JImgDataset(root, size).load_batch(), atol=1e-6)
    for i in range(len(ds)):
        np.testing.assert_allclose(batch[i], ds[i][0], atol=2 / 255.0)
    np.testing.assert_array_equal(ds.load_batch([2, 0]), batch[[2, 0]])


def _basis(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(24, 6)).astype(np.float32),
            rng.uniform(1, 3, size=(6,)).astype(np.float32),
            rng.normal(size=(6, 48)).astype(np.float32))


def test_basis_store_roundtrip_across_packages(lib, tmp_path):
    """The port writes .dpb; the JAX cache reads it bit for bit, and the
    port reads the JAX cache's .dpb; load_basis reads either by path."""
    u, s, vT = _basis()
    mine = BasisCache(str(tmp_path / "port")).save("b", u, s, vT)
    assert mine.endswith(".dpb")
    theirs = JBasisCache(str(tmp_path / "jax")).save("b", u, s, vT)
    assert theirs.endswith(".dpb")
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    for got in (JBasisCache(str(tmp_path / "port")).load("b"),
                BasisCache(str(tmp_path / "jax")).load("b"), load_basis(theirs),
                native.basis_read(theirs), jnative.basis_read(mine)):
        for a, b in zip(got, (u, s, vT)):
            np.testing.assert_array_equal(np.asarray(a), b)
    bad = str(tmp_path / "bad.dpb")
    with open(bad, "wb") as f:
        f.write(b"\x00" * 64)
    assert native.basis_read(bad) is None


def test_basis_falls_back_to_npz_without_the_library(tmp_path, monkeypatch):
    """No library: .npz, which both packages read, and a stale .dpb of the
    name is dropped so it cannot shadow the new file."""
    u, s, vT = _basis(1)
    cache = BasisCache(str(tmp_path))
    stale = cache.save("b", *_basis(2))
    assert stale.endswith(".dpb")
    monkeypatch.setattr(native, "get_lib", lambda: None)
    p = cache.save("b", u, s, vT)
    assert p.endswith(".npz") and not os.path.exists(stale)
    for got in (cache.load("b"), JBasisCache(str(tmp_path)).load("b"), load_basis(p)):
        for a, b in zip(got, (u, s, vT)):
            np.testing.assert_array_equal(np.asarray(a), b)
