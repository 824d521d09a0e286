"""Checkpoint / resume for long-running ensemble workloads.

Port of the portable npz half of :mod:`qbot_tpu.utils.checkpoint`
(``qbot_tpu/utils/checkpoint.py:24-56, 189-235``): arrays (tensors are
copied to the host) and JSON metadata under a directory, and a manager of
rolling step directories with a retention limit.
:func:`qbot_tpu_torch.frontend.lowering.run_lowered_ensemble` snapshots
its ensemble, event cursor, bound outcome distributions and, in sampling
mode, the state of its :class:`torch.Generator` through it;
``run_lowered_sharded_ensemble`` writes its metadata through it, beside
one shard file a rank.  The reference's Orbax manager is not ported.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "CheckpointManager"]

_META = "meta.json"
_ARRAYS = "arrays.npz"


def _to_host(tree: dict) -> dict:
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in tree.items()}


def save_checkpoint(path: str, arrays: dict, metadata: Optional[dict] = None,
                    step: Optional[int] = None) -> str:
    """Write arrays + JSON metadata under ``path`` (a directory)."""
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, _ARRAYS), **_to_host(arrays))
    meta = dict(metadata or {})
    if step is not None:
        meta["step"] = step
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f)
    return path


def load_checkpoint(path: str) -> tuple[dict, dict]:
    """Return (arrays as numpy, metadata)."""
    with np.load(os.path.join(path, _ARRAYS)) as z:
        arrays = {k: z[k] for k in z.files}
    meta_path = os.path.join(path, _META)
    metadata: dict[str, Any] = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            metadata = json.load(f)
    return arrays, metadata


class CheckpointManager:
    """Rolling checkpoints with a retention limit: one ``step_<n>``
    directory a save, the oldest removed past ``max_to_keep``."""

    def __init__(self, root: str, max_to_keep: int = 3):
        self.root = root
        self.max_to_keep = max_to_keep
        os.makedirs(root, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:010d}")

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.root):
            if name.startswith("step_"):
                try:
                    steps.append(int(name.split("_", 1)[1]))
                except ValueError:
                    continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, arrays: dict,
             metadata: Optional[dict] = None) -> str:
        path = save_checkpoint(self._step_dir(step), arrays, metadata, step)
        self._gc()
        return path

    def restore(self, step: Optional[int] = None) -> tuple[dict, dict]:
        """(arrays on the host, metadata) of ``step``, by default the
        latest; callers place the arrays on their device."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return load_checkpoint(self._step_dir(step))

    def _gc(self) -> None:
        steps = self.all_steps()
        while len(steps) > self.max_to_keep:
            victim = steps.pop(0)
            shutil.rmtree(self._step_dir(victim), ignore_errors=True)
