"""Checkpointing: path-flattened npz parameter-tree save/restore.

Counterpart of ``repro.checkpoint.io``, with the same file format, so a
file written by either package loads in the other: one npz entry a
leaf, keyed by its ``/``-joined path with ``/`` replaced by ``|``;
bfloat16 leaves (which numpy cannot hold) stored as float32 under
``key#bf16``.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from repro_torch.utils.pytree import tree_paths, tree_unflatten_like

_SEP = "|"


def save_pytree(tree, path: str) -> None:
    """Writes the nested dict of tensors (or arrays) ``tree`` to ``path``
    (``.npz`` appended if missing, as ``np.savez`` does)."""
    arrays: Dict[str, np.ndarray] = {}
    for p, leaf in tree_paths(tree):
        key = p.replace("/", _SEP)
        t = torch.as_tensor(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            arrays[key + "#bf16"] = t.float().numpy()
        else:
            arrays[key] = t.numpy()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def load_pytree(template, path: str):
    """Restores into the structure, shapes, dtypes and devices of
    ``template`` (tensors; a meta leaf loads onto the CPU).  Raises
    ``KeyError`` for a leaf the file lacks."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    leaves = []
    for p, leaf in tree_paths(template):
        key = p.replace("/", _SEP)
        if key in data:
            arr = data[key]
        elif key + "#bf16" in data:
            arr = data[key + "#bf16"]
        else:
            raise KeyError(f"checkpoint missing {key}")
        dev = "cpu" if leaf.device.type == "meta" else leaf.device
        leaves.append(torch.from_numpy(np.array(arr, order="C"))
                      .to(device=dev, dtype=leaf.dtype).reshape(leaf.shape))
    return tree_unflatten_like(template, leaves)
