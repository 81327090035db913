"""Checkpoints of the port (the surface of ``repro/checkpoint/store.py``):
``save`` / ``restore`` one tree of tensors, and ``CheckpointManager``,
which writes ``step_<N>.npz`` files into a directory and keeps the latest
``keep`` of them.  Writes are atomic (a temporary file, then a rename).

The files are numpy ``.npz`` archives written through ``bridge.save_npz``
(keys are ``/``-joined tree paths, bfloat16 stored as its bits), NOT the
reference's msgpack files: the port depends on no msgpack.  Weights made
by the JAX package reach the port through ``bridge.py``'s ``.npz``.
"""
from __future__ import annotations

import os
import re
from typing import Any, Optional

from repro_torch.bridge import flatten, load_npz, save_npz


def save(path: str, tree: Any) -> None:
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        save_npz(f, tree)
    os.replace(tmp, path)


def restore(path: str, like: Any = None) -> Any:
    """The tree saved at ``path`` as CPU tensors (the caller moves them).
    With ``like`` the saved tree must have its paths (its structure), else
    this raises."""
    tree = load_npz(path, device="cpu")
    if like is not None and set(flatten(like)) != set(flatten(tree)):
        raise ValueError(f"checkpoint {path} does not hold the structure of "
                         "the given tree")
    return tree


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _paths(self):
        pat = re.compile(r"^step_(\d+)\.npz$")
        out = []
        for f in os.listdir(self.dir):
            m = pat.match(f)
            if m:
                out.append((int(m.group(1)), os.path.join(self.dir, f)))
        return sorted(out)

    def save(self, step: int, tree: Any) -> str:
        path = os.path.join(self.dir, f"step_{step}.npz")
        save(path, tree)
        for _, old in self._paths()[:-self.keep]:
            os.remove(old)
        return path

    def latest_step(self) -> Optional[int]:
        ps = self._paths()
        return ps[-1][0] if ps else None

    def restore_latest(self, like: Any = None):
        ps = self._paths()
        if not ps:
            return None, None
        step, path = ps[-1]
        return step, restore(path, like)
