"""Checkpoint/resume for long-running solves — the port's copy of
gardenia_tpu/utils/checkpoint.py, without jax.

A state is a nested structure of tuples (named tuples included), lists
and dicts whose leaves are arrays, tensors or scalars; None holds no
leaf.  It is flattened in jax.tree_util's leaf order (sequences in order,
dicts by sorted key) and written atomically (mkstemp + os.replace) as an
.npz of `__meta__` (JSON: step, n_leaves, any extra metadata) and
`leaf_{i}`, the layout of the JAX package's Checkpointer, so either
restores what the other saved: both restore from `like=` and n_leaves
alone, so the JAX package's structure string is not written.  Tensors
are saved through .cpu(); leaves come back as numpy arrays.

Usage:
    ckpt = Checkpointer("/tmp/pr_lj")
    state = ckpt.restore() or initial_state
    ... run k iterations on device ...
    ckpt.save(state, step=n)
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, List, Optional

import numpy as np


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(state: Any) -> List[Any]:
    """The leaves of `state`, in jax.tree_util.tree_flatten's order."""
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [leaf for child in state for leaf in flatten(child)]
    if isinstance(state, dict):
        return [leaf for k in sorted(state) for leaf in flatten(state[k])]
    return [state]


def unflatten(like: Any, leaves: List[Any]) -> Any:
    """`leaves` put back into the structure of `like`."""
    it = iter(leaves)

    def rec(x):
        if x is None:
            return None
        if _is_namedtuple(x):
            return type(x)(*(rec(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(rec(v) for v in x)
        if isinstance(x, dict):
            return {k: rec(x[k]) for k in sorted(x)}
        return next(it)
    out = rec(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):            # a torch tensor
        x = x.detach().cpu().numpy()
    return np.asarray(x)


class Checkpointer:
    def __init__(self, prefix: str):
        self.prefix = prefix

    @property
    def _path(self) -> str:
        return self.prefix + ".ckpt.npz"

    def save(self, state: Any, step: int = 0, **meta) -> str:
        """Persist a nested structure of arrays atomically."""
        leaves = flatten(state)
        arrays = {f"leaf_{i}": _numpy(x) for i, x in enumerate(leaves)}
        payload = {"step": step, "n_leaves": len(leaves), **meta}
        d = os.path.dirname(os.path.abspath(self._path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, __meta__=json.dumps(payload), **arrays)
            os.replace(tmp, self._path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return self._path

    def restore(self, like: Optional[Any] = None):
        """Load the checkpoint; None if absent.  Returns (leaves, step), the
        leaves put back into the structure of `like` when it is given,
        else as a flat list of numpy arrays."""
        if not os.path.exists(self._path):
            return None
        with np.load(self._path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            leaves = [z[f"leaf_{i}"] for i in range(meta["n_leaves"])]
        if like is not None:
            return unflatten(like, leaves), meta["step"]
        return leaves, meta["step"]

    def step(self) -> int:
        if not os.path.exists(self._path):
            return -1
        with np.load(self._path, allow_pickle=False) as z:
            return json.loads(str(z["__meta__"]))["step"]
