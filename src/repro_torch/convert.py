"""Carry parameters between the JAX reference and the port.

The two packages share one parameter layout (nested dicts, the same
keys, stacked group axes, ``(in, out)`` matrices), so converting is a
pure tensor copy.  This module takes and returns numpy arrays, so it
needs no JAX: on the JAX side, ``jax.tree.map(np.asarray, params)``
gives its input and ``jax.tree.map(jnp.asarray, ...)`` takes its output.
Leaves are keyed by ``/``-joined paths, as ``repro.utils.pytree.path_str``
names them, and checked against the port's own layout for ``cfg``.
bfloat16 leaves cross as raw 16-bit words (numpy has no bfloat16 of its
own; the JAX side's is ``ml_dtypes.bfloat16``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf} of a nested dict, paths ``/``-joined."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


def _expected(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    return flatten(M.init_params(cfg, generator="meta"))


def _check_paths(got, want) -> None:
    if set(got) != set(want):
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        raise ValueError(f"parameter paths differ from the {len(want)}-leaf "
                         f"layout: missing {missing}, unexpected {extra}")


def params_from_jax(np_tree, cfg: ModelConfig, *, device="cpu"):
    """The port's parameter dict from the reference's parameters turned
    into numpy arrays.  Raises ``ValueError`` on a path or shape that is
    not the port's layout for ``cfg``, ``TypeError`` on a dtype that is
    not ``cfg.dtype``."""
    flat = flatten(np_tree)
    want = _expected(cfg)
    _check_paths(flat, want)
    out = {}
    for path, leaf in flat.items():
        a = np.asarray(leaf)
        w = want[path]
        if tuple(a.shape) != tuple(w.shape):
            raise ValueError(f"{path}: shape {tuple(a.shape)} != expected "
                             f"{tuple(w.shape)}")
        if a.dtype.name != str(w.dtype).removeprefix("torch."):
            raise TypeError(f"{path}: dtype {a.dtype.name} != expected "
                            f"{w.dtype}")
        a = np.array(a, order="C")  # a writable copy the tensor owns
        if w.dtype == torch.bfloat16:
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        out[path] = t.to(device)
    return unflatten(out)


def params_to_jax(params, cfg: ModelConfig):
    """The reference's parameter tree (numpy leaves) from the port's.
    bfloat16 leaves come back as ``ml_dtypes.bfloat16`` arrays, which
    needs that dtype registered with numpy (importing JAX does so)."""
    flat = flatten(params)
    want = _expected(cfg)
    _check_paths(flat, want)
    out = {}
    for path, t in flat.items():
        w = want[path]
        if tuple(t.shape) != tuple(w.shape) or t.dtype != w.dtype:
            raise ValueError(f"{path}: {t.dtype}{tuple(t.shape)} != expected "
                             f"{w.dtype}{tuple(w.shape)}")
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            out[path] = t.view(torch.int16).numpy().view(np.dtype("bfloat16"))
        else:
            out[path] = t.numpy()
    return unflatten(out)


_VAA_LEAVES = ("stage_proj", "wq", "wk", "wv", "wo", "out_proj")


def _check_vaa(shapes) -> None:
    """The six VAA leaves and the shapes they imply of one another:
    stage_proj (J, d_S, d), wq/wk/wv/wo (d, d), out_proj (J, d, d_T)."""
    if set(shapes) != set(_VAA_LEAVES):
        raise ValueError(f"VAA leaves {sorted(shapes)} != "
                         f"{sorted(_VAA_LEAVES)}")
    sp, op = shapes["stage_proj"], shapes["out_proj"]
    if len(sp) != 3 or len(op) != 3:
        raise ValueError(f"stage_proj {sp} and out_proj {op} must be 3-d")
    J, d = sp[0], sp[2]
    for k in ("wq", "wk", "wv", "wo"):
        if shapes[k] != (d, d):
            raise ValueError(f"{k}: shape {shapes[k]} != expected {(d, d)}")
    if op[:2] != (J, d):
        raise ValueError(f"out_proj: shape {op} != expected ({J}, {d}, d_T)")


def vaa_from_jax(np_tree, *, device="cpu"):
    """The port's VAA parameters (``core.vaa.init_vaa``'s six f32 leaves)
    from the reference's, turned into numpy arrays.  Raises
    ``ValueError`` on a missing, extra or mis-shaped leaf, ``TypeError``
    on a dtype other than float32."""
    shapes = {k: tuple(np.shape(v)) for k, v in np_tree.items()}
    _check_vaa(shapes)
    out = {}
    for k, leaf in np_tree.items():
        a = np.asarray(leaf)
        if a.dtype != np.float32:
            raise TypeError(f"{k}: dtype {a.dtype.name} != expected float32")
        out[k] = torch.from_numpy(np.array(a, order="C")).to(device)
    return out


def vaa_to_jax(params):
    """The reference's VAA parameters (numpy leaves) from the port's."""
    _check_vaa({k: tuple(v.shape) for k, v in params.items()})
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
