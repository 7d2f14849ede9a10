"""npz checkpointing in the reference's on-disk format.

Parameter and optimizer trees (nested dicts, NamedTuples such as
``AdamWState``, lists) are flattened to ``path/to/leaf`` keys and stored
in one compressed npz per step, array ``"{tree}::{path}"``, beside a
small JSON manifest ``{"step", "trees": {name: sorted paths}}``: the
files ``repro.checkpoint.io`` writes and reads, so a checkpoint crosses
between the two packages.  A bfloat16 leaf is stored as the reference
stores one, its 16 bits as numpy void ``|V2``, and read back into a
bfloat16 template through an int16 view (the reference cannot restore
such a leaf itself: ``astype`` has no cast from ``|V2``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _items(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in the reference's flattening order: dict keys
    sorted, NamedTuple fields and list items in order."""
    if isinstance(tree, dict):
        children = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        children = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        children = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, child in children:
        out += _items(child, f"{prefix}/{key}" if prefix else key)
    return out


def _rebuild(template: Any, leaves) -> Any:
    """``template``'s structure with its leaves taken in turn from ``leaves``."""
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves) for k in sorted(template)}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(v, leaves) for v in template))
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaves) for v in template)
    return next(leaves)


def _to_numpy(leaf: Any) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    if hasattr(leaf, "full_tensor"):  # a DTensor: every rank gathers the whole
        leaf = leaf.full_tensor()
    leaf = leaf.detach().cpu()
    if leaf.dtype == torch.bfloat16:
        return leaf.view(torch.int16).numpy().view("V2")
    return leaf.numpy()


def _to_tensor(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    if arr.dtype == np.dtype("V2"):
        if dtype != torch.bfloat16:
            raise ValueError(f"a bfloat16 (|V2) array cannot restore a {dtype} leaf")
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(dtype)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {path: _to_numpy(leaf) for path, leaf in _items(tree)}


def save(directory: str, step: int, trees: Dict[str, Any]) -> str:
    """trees: e.g. {"params": ..., "opt_state": ...}. Returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}")
    arrays: Dict[str, np.ndarray] = {}
    manifest = {"step": step, "trees": {}}
    for name, tree in trees.items():
        flat = _flatten(tree)
        manifest["trees"][name] = sorted(flat)
        for k, v in flat.items():
            arrays[f"{name}::{k}"] = v
    np.savez_compressed(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump(manifest, f)
    return path + ".npz"


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(f[len("ckpt_") : -len(".json")])
        for f in os.listdir(directory)
        if f.startswith("ckpt_") and f.endswith(".json")
    ]
    return max(steps) if steps else None


def restore(
    directory: str,
    step: int,
    templates: Dict[str, Any],
    shardings: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Restore trees matching ``templates``' structure and leaf dtypes, on
    the CPU.  ``shardings``, when given, maps a tree name to where its
    leaves go: a ``torch.device`` or its name (one device), or a
    ``(mesh, specs)`` pair — a ``DeviceMesh`` and a spec tree matching the
    template (``sharding.specs``) — which makes each leaf a DTensor placed
    by its spec (every rank reads the file and keeps its shard).  Any other
    kind of placement raises ``TypeError``."""
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    out = {}
    with np.load(path) as data:
        for name, template in templates.items():
            where = shardings.get(name) if shardings else None
            leaves = [_to_tensor(data[f"{name}::{key}"], leaf.dtype)
                      for key, leaf in _items(template)]
            if isinstance(where, tuple):
                from repro_torch.sharding import specs

                mesh, spec_tree = where
                leaves = [t.to(mesh.device_type) for t in leaves]
                out[name] = specs.distribute(_rebuild(template, iter(leaves)), spec_tree, mesh)
            else:
                if where is not None and not isinstance(where, (str, torch.device)):
                    raise TypeError(
                        f"restore places a tree on a device or by (mesh, specs); a "
                        f"{type(where).__name__} is neither")
                if where is not None:
                    leaves = [t.to(where) for t in leaves]
                out[name] = _rebuild(template, iter(leaves))
    return out
