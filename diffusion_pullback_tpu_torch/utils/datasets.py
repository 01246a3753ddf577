"""Datasets: numbered-image folders, seeded noise, the benchmark, local
HuggingFace and LSUN sets, and prompt lists (counterpart of
diffusion_pullback_tpu/utils/datasets.py). Items are (1, S, S, 3) float32
NHWC arrays in [-1, 1]; batches (n, S, S, 3)."""

from __future__ import annotations

import os
import re
import sys
from typing import List, Optional

import numpy as np

from .images import load_image

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class ImgDataset:
    """Folder of images, ordered by the integer in each filename."""

    EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")

    def __init__(self, root: str, image_size: int):
        self.root = root
        self.image_size = image_size
        names = [f for f in os.listdir(root) if f.lower().endswith(self.EXTS)]

        def key(name: str):
            m = re.search(r"\d+", name)
            return (int(m.group()) if m else 1 << 30, name)

        self.files: List[str] = [os.path.join(root, f) for f in sorted(names, key=key)]
        if not self.files:
            raise FileNotFoundError(f"no images under {root}")

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> np.ndarray:
        return load_image(self.files[idx], self.image_size)

    def load_batch(self, indices=None) -> np.ndarray:
        """(n, S, S, 3) of the items ``indices`` (default all), decoded by
        the native library's threaded decoder (one libjpeg / libpng worker
        per hardware thread); an item it cannot decode, or every item when
        the library has no codecs, goes through ``load_image``."""
        from .native import decode_batch

        paths = [self.files[i] for i in (range(len(self)) if indices is None
                                         else indices)]
        res = decode_batch(paths, self.image_size)
        if res is None:
            return np.concatenate([load_image(p, self.image_size) for p in paths])
        out, ok = res
        for j in np.flatnonzero(~ok):
            out[j] = load_image(paths[j], self.image_size)[0]
        return out


class NoiseDataset:
    """Deterministic Gaussian 'images' (NHWC, in (-1, 1)) for offline runs;
    the same arrays as the JAX package's NoiseDataset."""

    def __init__(self, image_size: int, n: int = 8, scale: float = 0.7):
        self.image_size = image_size
        self.n = n
        self.scale = scale

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(idx)
        x = rng.normal(size=(1, self.image_size, self.image_size, 3))
        return np.tanh(x.astype(np.float32)) * self.scale


def get_dataset(dataset_name: str, image_size: int,
                data_root: Optional[str] = None):
    """'noise' → NoiseDataset; any other name → the first image folder among
    ``data_root``, ``data_root/<name lower>`` and the repository's
    ``datasets/<name lower>`` and ``datasets/<name>``; for CelebA_HQ and
    Examples without such a folder, their synthetic images generated into
    ~/.cache/diffusion_pullback_tpu_torch/datasets. Raises FileNotFoundError
    when no folder holds images."""
    if dataset_name == "noise":
        return NoiseDataset(image_size)
    candidates = []
    if data_root:
        candidates += [data_root, os.path.join(data_root, dataset_name.lower())]
    candidates += [os.path.join(_REPO, "datasets", dataset_name.lower()),
                   os.path.join(_REPO, "datasets", dataset_name)]
    for c in candidates:
        if os.path.isdir(c):
            try:
                return ImgDataset(c, image_size)
            except FileNotFoundError:
                continue
    if dataset_name.lower() in ("celeba_hq", "examples"):
        # the two bundled sets, regenerated (scripts/make_sample_images.py
        # writes the same files as datasets/ holds) into the user's cache
        gen_root = os.path.join(os.path.expanduser("~"), ".cache",
                                "diffusion_pullback_tpu_torch", "datasets")
        sys.path.insert(0, os.path.join(_REPO, "scripts"))
        try:
            from make_sample_images import generate
        finally:
            sys.path.pop(0)
        generate(gen_root)
        print(f"[datasets] {dataset_name!r} folder missing — using the generated "
              f"synthetic sample set under {gen_root}")
        return ImgDataset(os.path.join(gen_root, dataset_name.lower()), image_size)
    raise FileNotFoundError(
        f"dataset {dataset_name!r} not found (searched {candidates}); "
        "use dataset_name='noise' for offline runs or pass data_root")


class BenchmarkDataset:
    """A raw_images/{train,test}/images folder of integer-named images,
    resized to img_size without a crop (the stretch of the reference's
    BenchmarkDataset, unlike ImgDataset's centre crop) by PIL's bilinear
    filter."""

    EXTS = ("jpg", "jpeg", "png")

    def __init__(self, image_root: str, img_size: int = 256, is_train: bool = True):
        split = "train" if is_train else "test"
        self.image_dir = os.path.join(image_root, "raw_images", split, "images")
        names = [n for n in os.listdir(self.image_dir)
                 if n.split(".")[-1].lower() in self.EXTS]
        self.files = sorted(names, key=lambda n: int(n.split(".")[0]))
        if not self.files:
            raise FileNotFoundError(f"no images under {self.image_dir}")
        self.img_size = img_size

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> np.ndarray:
        from PIL import Image

        img = Image.open(os.path.join(self.image_dir, self.files[idx]))
        img = img.convert("RGB").resize((self.img_size, self.img_size))
        arr = np.asarray(img, np.float32) / 255.0
        return (arr * 2.0 - 1.0)[None]


def _pil_to_item(img, image_size: int) -> np.ndarray:
    """A PIL image → (1, S, S, 3): the native crop/resize/normalise, else
    load_image's (the same centre crop and resize in torch)."""
    from .native import crop_resize_normalize

    arr = np.asarray(img.convert("RGB"), np.uint8)
    out = crop_resize_normalize(arr, image_size)
    return out[None] if out is not None else load_image(img, image_size)


class HFDataset:
    """A HuggingFace ``datasets`` folder on disk (``save_to_disk``; the
    first split of a DatasetDict); nothing is downloaded. Items are the
    ``image_key`` column, centre-cropped and resized."""

    def __init__(self, path: str, image_size: int, image_key: str = "image"):
        try:
            import datasets as hfds
        except ImportError as e:
            raise RuntimeError("the `datasets` package is required") from e
        self.ds = hfds.load_from_disk(path)
        if hasattr(self.ds, "keys"):
            self.ds = self.ds[list(self.ds.keys())[0]]
        self.image_size = image_size
        self.image_key = image_key

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, idx: int) -> np.ndarray:
        return _pil_to_item(self.ds[int(idx)][self.image_key], self.image_size)


class LSUNDataset:
    """An LSUN lmdb folder (one encoded image per key), gated on the
    optional ``lmdb`` package. Items are centre-cropped and resized."""

    def __init__(self, root: str, image_size: int):
        try:
            import lmdb
        except ImportError as e:
            raise RuntimeError(
                "LSUN datasets need the `lmdb` package (not in this image); "
                "export the images to a folder and use ImgDataset instead"
            ) from e
        self.env = lmdb.open(root, max_readers=1, readonly=True, lock=False,
                             readahead=False, meminit=False)
        with self.env.begin(write=False) as txn:
            self.length = txn.stat()["entries"]
            self.keys = [k for k, _ in txn.cursor()]
        self.image_size = image_size

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int) -> np.ndarray:
        import io

        from PIL import Image

        with self.env.begin(write=False) as txn:
            buf = txn.get(self.keys[idx])
        return _pil_to_item(Image.open(io.BytesIO(buf)), self.image_size)


# the built-in caption bank (this package's copy of the JAX package's), the
# last fallback of get_prompt_list
_BUILTIN_CAPTIONS = [
    "a photo of a dog", "a photo of a cat", "a person smiling",
    "a red car on the street", "a mountain landscape at sunset",
    "a bowl of fruit on a table", "a city skyline at night",
    "a bird sitting on a branch", "a plate of pasta", "a child playing",
]
# the bundled 50 COCO-style captions, one per line
_SHIPPED_PROMPT_FILE = os.path.join(_REPO, "inputs", "prompts_coco50.txt")


def get_prompt_list(num_captions: int = 10, path: Optional[str] = None) -> List[str]:
    """``num_captions`` prompts from a local captions file (one per line, or
    a .json list), else the bundled inputs/prompts_coco50.txt, else the
    built-in 10-caption bank; the list repeats to reach ``num_captions``."""
    if not (path and os.path.exists(path)):
        path = _SHIPPED_PROMPT_FILE if os.path.exists(_SHIPPED_PROMPT_FILE) else None
    caps: List[str] = []
    if path:
        import json

        with open(path) as f:
            caps = json.load(f) if path.endswith(".json") else [
                line.strip() for line in f if line.strip()]
    caps = caps or _BUILTIN_CAPTIONS
    reps = (num_captions + len(caps) - 1) // len(caps)
    return (caps * reps)[:num_captions]
