"""Checkpointing: atomic, keep-N, resumable (counterpart of
``repro/checkpoint/manager.py``, in its on-disk format).

Format: one directory per step —

    <dir>/step_000123/
        manifest.json        tree structure, dtypes, shapes, step, extras
        arrays.npz           flat leaf arrays (on the host)
        .complete            commit marker (written LAST)

* ATOMIC: writes go to ``step_xxx.tmp`` and are renamed after the commit
  marker lands; ``latest_step`` ignores directories without the marker.
* KEEP-N: older complete checkpoints are pruned after a commit.
* THE REFERENCE'S FORMAT: leaf keys are spelled as the JAX package spells
  them (``repro_torch.core.tree.leaves_with_paths``: ``['params']/
  ['embed']/['table']``, ``['opt']/.m/...``), dtypes by their numpy names,
  and bfloat16 goes through a uint16 view (numpy has no bfloat16), so a
  checkpoint written by either package restores into the other.

There is no sharding argument yet: every leaf is restored onto the device
of the matching leaf of the target tree.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import tree as _tree

_MARKER = ".complete"


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype_name: str,
                device: torch.device) -> torch.Tensor:
    if dtype_name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.asarray(arr, dtype=dtype_name).copy()).to(
        device)


def save(directory: str, step: int, tree: Any,
         extras: Optional[Dict[str, Any]] = None, keep: int = 3) -> str:
    """Save ``tree`` (a tree of tensors) atomically. Returns the final
    path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays = {}
    manifest_leaves = {}
    for key, leaf in _tree.leaves_with_paths(tree):
        leaf = torch.as_tensor(leaf)
        arr = _to_numpy(leaf)
        arrays[key] = arr
        manifest_leaves[key] = {"dtype": _dtype_name(leaf),
                                "shape": list(arr.shape)}

    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": step, "leaves": manifest_leaves,
                "extras": extras or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, _MARKER), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    for old in all_steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{old:08d}"),
                      ignore_errors=True)
    return final


def all_steps(directory: str):
    steps = []
    if not os.path.isdir(directory):
        return steps
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, _MARKER)):
                steps.append(int(name.split("_")[1]))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, target_tree: Any, step: Optional[int] = None,
            ) -> Tuple[Any, int, Dict[str, Any]]:
    """Restore into the structure of ``target_tree``: each leaf takes the
    dtype recorded in the manifest and the device of the target's leaf.
    Returns (tree, step, extras)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))

    out = []
    for key, ref in _tree.leaves_with_paths(target_tree):
        if key not in manifest["leaves"]:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        info = manifest["leaves"][key]
        ref = torch.as_tensor(ref)
        arr = _from_numpy(data[key], info["dtype"], ref.device)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch for {key!r}: ckpt "
                             f"{tuple(arr.shape)} vs {tuple(ref.shape)}")
        out.append(arr)
    return _tree.unflatten(target_tree, out), step, manifest.get("extras", {})
