"""ctypes bindings of the native image and basis library (counterpart of
diffusion_pullback_tpu/utils/native.py, with the same functions and C
signatures).

The library is built from the C++ sources at the repository's root,
native/imageproc.cpp and native/basisstore.cpp, with g++ and the flags of
native/Makefile (``-DDPX_WITH_CODECS`` and libjpeg / libpng when their
headers are found), into ``.build/`` next to this package, keyed on the
sources, the flags and the host's ``-march=native`` target. It never
writes into native/ and never loads the library file kept there, which was
built on another machine. Every function returns None (False for
``basis_write`` and ``has_codecs``) when the library cannot be built or
loaded, and the callers fall back to their PIL / .npz paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO, "native")
SOURCES = ("imageproc.cpp", "basisstore.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         ".build")
CXX = "g++"
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _run(cmd, **kw) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=120, **kw)


def _has_codec_headers() -> bool:
    """native/Makefile's probe: do jpeglib.h and png.h preprocess?"""
    try:
        return _run([CXX, "-E", "-x", "c++", "-"],
                    input="#include <jpeglib.h>\n#include <png.h>\n").returncode == 0
    except (OSError, subprocess.TimeoutExpired):
        return False


def _march() -> str:
    """The target ``-march=native`` resolves to on this host (the library
    is built for it, so a copy of the build folder on another host does
    not match)."""
    out = _run([CXX, "-march=native", "-Q", "--help=target"]).stdout
    for line in out.splitlines():
        parts = line.split()
        if len(parts) == 2 and parts[0] == "-march=":
            return parts[1]
    return "unknown"


def build() -> str:
    """Compile the library (if these sources are not built yet for this
    host) and return its path. Raises when g++ fails."""
    codecs = _has_codec_headers()
    flags = CXXFLAGS + (("-DDPX_WITH_CODECS",) if codecs else ())
    libs = ("-ljpeg", "-lpng") if codecs else ()
    digest = hashlib.sha256(" ".join(flags + libs + (_march(),)).encode())
    for name in SOURCES:
        with open(os.path.join(NATIVE_DIR, name), "rb") as f:
            digest.update(name.encode() + f.read())
    path = os.path.join(BUILD_DIR, f"dpximg-{digest.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = os.path.join(tmp, "dpximg.so")
        proc = _run([CXX, *flags, "-shared", "-o", so,
                     *(os.path.join(NATIVE_DIR, n) for n in SOURCES), *libs])
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(so, path)
    return path


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library with its signatures set, or None when it cannot
    be built or loaded (tried once per process)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(build())
        except (OSError, RuntimeError, subprocess.TimeoutExpired):
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        ci = ctypes.c_int
        lib.dpx_crop_resize_normalize.argtypes = [u8p, ci, ci, ci, f32p, ci]
        lib.dpx_crop_resize_normalize.restype = None
        lib.dpx_batch_to_grid_u8.argtypes = [f32p, ci, ci, ci, ci, ci, u8p]
        lib.dpx_batch_to_grid_u8.restype = None
        lib.dpx_version.restype = ci
        lib.dpx_has_codecs.argtypes = []
        lib.dpx_has_codecs.restype = ci
        if hasattr(lib, "dpx_decode_crop_resize"):
            lib.dpx_decode_crop_resize.argtypes = [ctypes.c_char_p, ci, f32p]
            lib.dpx_decode_crop_resize.restype = ci
            lib.dpx_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ci, ci, f32p, ctypes.POINTER(ci)]
            lib.dpx_decode_batch.restype = ci
        lib.dpx_basis_write.argtypes = [ctypes.c_char_p, f32p, ci, ci, f32p, ci,
                                        f32p, ci, ci]
        lib.dpx_basis_write.restype = ci
        lib.dpx_basis_read_header.argtypes = [ctypes.c_char_p, ctypes.POINTER(ci)]
        lib.dpx_basis_read_header.restype = ci
        _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def crop_resize_normalize(img_u8: np.ndarray, out_size: int) -> Optional[np.ndarray]:
    """uint8 HWC → (out, out, C) float32 in [-1, 1]: centre crop to the
    largest square, bilinear resize at pixel centres; None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    h, w, c = img_u8.shape
    out = np.empty((out_size, out_size, c), np.float32)
    lib.dpx_crop_resize_normalize(_ptr(img_u8, ctypes.c_uint8), h, w, c,
                                  _ptr(out, ctypes.c_float), out_size)
    return out


def batch_to_grid(batch_f32: np.ndarray, nrow: int) -> Optional[np.ndarray]:
    """[-1, 1] NHWC float32 → uint8 grid of ``nrow`` images per row; None
    without the library."""
    lib = get_lib()
    if lib is None:
        return None
    batch_f32 = np.ascontiguousarray(batch_f32, np.float32)
    n, h, w, c = batch_f32.shape
    ncol = (n + nrow - 1) // nrow
    grid = np.empty((ncol * h, nrow * w, c), np.uint8)
    lib.dpx_batch_to_grid_u8(_ptr(batch_f32, ctypes.c_float), n, h, w, c, nrow,
                             _ptr(grid, ctypes.c_uint8))
    return grid


def has_codecs() -> bool:
    """True when the library was built with libjpeg / libpng and decodes
    images itself."""
    lib = get_lib()
    return bool(lib is not None and lib.dpx_has_codecs())


def decode_crop_resize(path: str, out_size: int) -> Optional[np.ndarray]:
    """Decode (libjpeg / libpng), centre-crop, resize and normalise one
    image → (out, out, 3) float32; None without the codecs or when the
    file's codec or colour space is not handled (the caller uses PIL)."""
    if not has_codecs():
        return None
    out = np.empty((out_size, out_size, 3), np.float32)
    rc = get_lib().dpx_decode_crop_resize(path.encode(), out_size,
                                          _ptr(out, ctypes.c_float))
    return out if rc == 0 else None


def decode_batch(paths, out_size: int):
    """(n, out, out, 3) float32 of ``paths`` decoded by one worker per
    hardware thread, and the per-item ok mask (a failed item is for the
    caller to load through PIL); None without the codecs."""
    if not has_codecs():
        return None
    n = len(paths)
    out = np.empty((n, out_size, out_size, 3), np.float32)
    status = np.empty((n,), np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    get_lib().dpx_decode_batch(arr, n, out_size, _ptr(out, ctypes.c_float),
                               _ptr(status, ctypes.c_int))
    return out, status == 0


_BASIS_HEADER_BYTES = 32


def basis_write(path: str, u: np.ndarray, s: np.ndarray, vT: np.ndarray) -> bool:
    """Write one (u, s, vT) basis as float32 in the native format (32-byte
    header, then u, s, vT; temp file, fsync, rename). False without the
    library or when the write failed."""
    lib = get_lib()
    if lib is None:
        return False
    u, s, vT = (np.ascontiguousarray(a, np.float32) for a in (u, s, vT))
    f32 = ctypes.c_float
    rc = lib.dpx_basis_write(path.encode(), _ptr(u, f32), u.shape[0], u.shape[1],
                             _ptr(s, f32), s.shape[0], _ptr(vT, f32), vT.shape[0],
                             vT.shape[1])
    return rc == 0


def basis_read(path: str):
    """(u, s, vT) of a native basis file as read-only np.memmap views;
    None without the library or when the header does not check."""
    lib = get_lib()
    if lib is None:
        return None
    dims = (ctypes.c_int * 5)()
    if lib.dpx_basis_read_header(path.encode(), dims) != 0:
        return None
    u0, u1, k, v0, v1 = (int(d) for d in dims)
    off = _BASIS_HEADER_BYTES
    u = np.memmap(path, np.float32, "r", offset=off, shape=(u0, u1))
    off += 4 * u0 * u1
    s = np.memmap(path, np.float32, "r", offset=off, shape=(k,))
    off += 4 * k
    vT = np.memmap(path, np.float32, "r", offset=off, shape=(v0, v1))
    return u, s, vT
