"""Training-state checkpointing: one atomic .npz per step.

The render side checkpoints partial images (driver.py, atomic npz); this
module checkpoints the TRAINING state — (params, opt_state, step) — the
same way: the pytree is flattened to its leaves, written with np.savez to
a temporary file and moved into place with os.replace, so a reader never
sees a half-written step. Restore takes a like-shaped tree for the
structure. In a multi-process run only process 0 writes. The reference
has no training, so there is no counterpart to cite (SURVEY.md §5
checkpoint/resume: "Absent").
"""
from __future__ import annotations

import glob
import os
import re
from typing import Any, Optional, Tuple

import jax
import numpy as np


def _step_path(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step:08d}.npz")


def _steps(path: str):
    found = []
    for p in glob.glob(os.path.join(path, "step_*.npz")):
        m = re.fullmatch(r"step_(\d+)\.npz", os.path.basename(p))
        if m:
            found.append(int(m.group(1)))
    return sorted(found)


def save_train_state(path: str, step: int, params: Any,
                     opt_state: Any = None,
                     max_to_keep: int = 3) -> None:
    """Atomically save (params, opt_state) at `step` under directory
    `path`. Keeps the newest `max_to_keep` steps."""
    n_params = len(jax.tree.leaves(params))
    leaves = jax.tree.leaves((params, opt_state))
    arrays = [np.asarray(jax.device_get(x)) for x in leaves]
    if jax.process_index() != 0:
        return
    os.makedirs(path, exist_ok=True)
    final = _step_path(path, step)
    tmp = final + ".tmp.npz"
    np.savez(tmp, *arrays, n_params=np.int64(n_params))
    os.replace(tmp, final)
    for old in _steps(path)[:-max_to_keep]:
        os.remove(_step_path(path, old))


def restore_train_state(
    path: str,
    params_like: Any,
    opt_state_like: Any = None,
    step: Optional[int] = None,
) -> Tuple[int, Any, Any]:
    """Restore (step, params, opt_state) from `path`. `*_like` provide
    the tree structure (e.g. freshly initialized state); shapes must
    match. With `opt_state_like=None` only the params are restored.
    `step=None` restores the latest step."""
    if step is None:
        steps = _steps(path)
        if not steps:
            raise FileNotFoundError(f"no checkpoint steps under {path}")
        step = steps[-1]
    like = (params_like, opt_state_like)
    like_leaves, treedef = jax.tree.flatten(like)
    with np.load(_step_path(path, step), allow_pickle=False) as z:
        n_params = int(z["n_params"])
        arrays = [z[f"arr_{i}"] for i in range(len(z.files) - 1)]
    if opt_state_like is None:
        arrays = arrays[:n_params]
    if len(arrays) != len(like_leaves):
        raise ValueError(
            f"checkpoint step {step} holds {len(arrays)} arrays, the "
            f"target tree has {len(like_leaves)} leaves")
    for a, b in zip(arrays, like_leaves):
        if a.shape != np.shape(b):
            raise ValueError(
                f"checkpoint leaf shape {a.shape} != target {np.shape(b)}")
    state = jax.tree.unflatten(
        treedef, [jax.numpy.asarray(a, dtype=np.asarray(b).dtype)
                  for a, b in zip(arrays, like_leaves)])
    return step, state[0], state[1]
