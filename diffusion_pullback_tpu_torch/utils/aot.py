"""Program export: the drivers' per-step programs as torch.export programs
saved on disk (counterpart of diffusion_pullback_tpu/utils/aot.py).

``AOTProgramCache.wrap(name, fn, fingerprint)`` returns a callable that, on
its first call per argument layout, loads the program stored under the
key (program name, argument shapes and dtypes, device name, a salt over
the port's sources, the caller's fingerprint of its config) or exports
``fn`` with ``torch.export.export`` and stores it with
``torch.export.save``; later calls run the loaded program's module. The
flash kernels are custom ops with fake implementations, so a program that
reaches them exports, and the exported graph calls the same ops: a loaded
program runs the same kernels on the same device as the eager call.

Weights are arguments, as in the JAX package: a driver exports
``torch.func.functional_call`` of its modules with their parameters and
buffers as an input dict, so the file holds the graph and not the
weights.

An export or a load that fails is printed once and the program runs
eagerly. The port's eager programs are what the exported ones run; the
cache saves the trace of a later process, never a result. Each program's
outcome is logged once as an ``aot_program`` event: 'exported', 'loaded'
or 'eager', with the reason.
"""

from __future__ import annotations

import hashlib
import os
import sys
import time
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SALT: Optional[str] = None


def _code_salt() -> str:
    """Hash of torch's version and the contents of the port's .py and
    csrc/*.cu / *.cuh files: editing model, op or kernel code invalidates
    every stored program."""
    global _SALT
    if _SALT is None:
        h = hashlib.sha256(torch.__version__.encode())
        for root, dirs, files in sorted(os.walk(_PKG_DIR)):
            dirs[:] = sorted(d for d in dirs if d not in ("__pycache__", ".build"))
            for f in sorted(files):
                if f.endswith((".py", ".cu", ".cuh")):
                    p = os.path.join(root, f)
                    with open(p, "rb") as fh:
                        h.update(os.path.relpath(p, _PKG_DIR).encode() + fh.read())
        _SALT = h.hexdigest()[:16]
    return _SALT


def code_salt() -> str:
    """The port's source salt (the key's code part)."""
    return _code_salt()


def default_export_dir() -> str:
    return os.path.join(os.path.dirname(_PKG_DIR), ".torch_cache", "exports")


def _arg_key(args) -> str:
    """Digest of the arguments' tree, each tensor's shape, dtype and device
    type, and each other leaf's value (export bakes it in)."""
    leaves, spec = pytree.tree_flatten(args)
    parts = [str(spec)]
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            parts.append(f"{tuple(leaf.shape)}:{leaf.dtype}:{leaf.device.type}")
        else:
            parts.append(repr(leaf))
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:20]


def _device_kind(args) -> str:
    for leaf in pytree.tree_leaves(args):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            return torch.cuda.get_device_name(leaf.device)
    return "cpu"


class _Fn(torch.nn.Module):
    """``fn`` as the module torch.export takes; it registers nothing, so
    every tensor the program reads is an argument or made inside it."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


class AOTProgramCache:
    """The stored programs of one process (see the module docstring).
    ``logger`` (a JSONLLogger) receives the ``aot_program`` events."""

    def __init__(self, directory: Optional[str] = None, logger=None):
        self.dir = directory or default_export_dir()
        self.logger = logger
        self._loaded: dict = {}

    def _path(self, name: str, args, fingerprint: str = "") -> str:
        kind = _device_kind(args).replace(" ", "_")
        key = f"{name}-{_arg_key(args)}-{kind}-{_code_salt()}-{fingerprint}"
        safe = "".join(c if c.isalnum() or c in "._-" else "_" for c in key)
        return os.path.join(self.dir, safe + ".pt2")

    def _log(self, name: str, status: str, **fields) -> None:
        if self.logger is not None:
            self.logger.log("aot_program", name=name, status=status, **fields)

    def wrap(self, name: str, fn: Callable, fingerprint: str = "") -> Callable:
        """``fingerprint`` must digest every config value ``fn`` bakes in
        as a constant (guidance scales, step grids, dtypes), so a process
        run with other flags does not load a program with the old ones."""
        def call(*args):
            key = (name, _arg_key(args), fingerprint)
            runner = self._loaded.get(key)
            if runner is None:
                runner = self._load_or_export(name, fn, args, fingerprint)
                self._loaded[key] = runner
            return runner(*args)

        return call

    def _load_or_export(self, name: str, fn: Callable, args, fingerprint: str = ""
                        ) -> Callable:
        path = self._path(name, args, fingerprint)
        reason = "no stored program"
        if os.path.exists(path):
            t0 = time.perf_counter()
            try:
                runner = torch.export.load(path).module()
                self._log(name, "loaded", path=path, seconds=time.perf_counter() - t0)
                return runner
            except Exception as e:  # unreadable or stale file: export again
                reason = f"stored program unreadable: {type(e).__name__}: {str(e)[:200]}"
        t0 = time.perf_counter()
        try:
            ep = torch.export.export(_Fn(fn), tuple(args))
            # the example inputs hold the weights: not stored with the graph
            ep.example_inputs = None
            os.makedirs(self.dir, exist_ok=True)
            tmp = f"{path[:-4]}.tmp{os.getpid()}.pt2"
            torch.export.save(ep, tmp)
            os.replace(tmp, path)
            runner = ep.module()
        except Exception as e:
            # an op export cannot trace, a version skew, the disk: run the
            # eager function, and say so once (a silent fall-back would
            # read as a cache that never hits)
            msg = f"{type(e).__name__}: {str(e)[:200]}"
            print(f"[aot] export unavailable for {name}: {msg}", file=sys.stderr,
                  flush=True)
            self._log(name, "eager", reason=msg)
            return fn
        self._log(name, "exported", path=path, reason=reason,
                  seconds=time.perf_counter() - t0)
        return runner
