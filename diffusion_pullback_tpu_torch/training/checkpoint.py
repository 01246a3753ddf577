"""Step-numbered training checkpoints with resume discovery (counterpart of
diffusion_pullback_tpu/training/checkpoint.py, which writes them with
orbax).

Each checkpoint is a folder ``step_{:08d}`` holding one ``torch.save`` file
of the step, the f32 params, every EMA copy (a tuple stays a tuple) and the
optimizer's ``state_dict``. A save writes a hidden temporary folder, syncs
it to disk and renames it into place, so a folder named ``step_*`` is
always whole: a save that fails leaves nothing behind.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
from typing import Optional

import torch

from .train import TrainState

_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def _steps(self):
        return sorted(int(m.group(1)) for name in os.listdir(self.directory)
                      if (m := re.fullmatch(r"step_(\d+)", name)))

    def save(self, state: TrainState) -> str:
        """Write ``state`` as step ``state.step`` (raises FileExistsError if
        that step is saved already), then keep only the ``keep`` newest."""
        path = self._path(int(state.step))
        if os.path.exists(path):
            raise FileExistsError(f"checkpoint {path} exists")
        tmp = tempfile.mkdtemp(prefix=f".{os.path.basename(path)}.", dir=self.directory)
        try:
            with open(os.path.join(tmp, _FILE), "wb") as f:
                torch.save({"step": int(state.step),
                            "params": {k: v.detach() for k, v in state.params.items()},
                            "ema_params": state.ema_params,
                            "opt_state": state.opt_state.state_dict()}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        dir_fd = os.open(self.directory, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
        self._gc()
        return path

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, template: TrainState, step: Optional[int] = None) -> TrainState:
        """Load step ``step`` (default: the latest) into ``template`` (a
        state of the same model and optimizer, e.g. from
        create_train_state): its tensors are overwritten in place, on their
        own devices, and the state is returned with the saved step.
        Raises FileNotFoundError when there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        saved = torch.load(os.path.join(self._path(step), _FILE), map_location="cpu",
                           weights_only=True)
        ema = template.ema_params
        if isinstance(ema, tuple) != isinstance(saved["ema_params"], tuple) or (
                isinstance(ema, tuple) and len(ema) != len(saved["ema_params"])):
            raise ValueError("the template's EMA copies do not match the checkpoint's")
        pairs = [(template.params, saved["params"])] + (
            list(zip(ema, saved["ema_params"])) if isinstance(ema, tuple)
            else [(ema, saved["ema_params"])])
        with torch.no_grad():
            for mine, theirs in pairs:
                if mine.keys() != theirs.keys():
                    raise ValueError("the template's parameter names do not match "
                                     "the checkpoint's")
                for k, v in mine.items():
                    v.copy_(theirs[k])
        template.opt_state.load_state_dict(saved["opt_state"])
        return template._replace(step=saved["step"])

    def _gc(self):
        for s in self._steps()[: -self.keep or None]:
            shutil.rmtree(self._path(s), ignore_errors=True)
