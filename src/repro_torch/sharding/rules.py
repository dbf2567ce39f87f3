"""Parameter, optimizer-state, batch and cache sharding rules.

Counterpart of ``repro.sharding.rules``: the same rules, as pure
functions over the port's trees (nested dicts of tensors; meta tensors
will do).  A spec is a tuple with one entry a dim, the entries of the
reference's ``PartitionSpec``: None (replicated), an axis name, or a
tuple of axis names (the dim split over their product, the first axis
major).  Rules match parameter *paths* (``blocks/sub0/moe/wo``) and
apply to the trailing dims; leading stacked group axes replicate.

* Megatron-style tensor parallelism on "model": attention heads and FFN
  hidden columns; the MoE's expert dim on "model" (``ep_all``: over the
  whole mesh, the serving layout of ``moe_replicated_ep``).
* FSDP/ZeRO over the data axes: the first large replicated dim of each
  leaf is also split over "data" (and "pod").

A mesh here is anything with axis names and sizes: ``abstract_mesh``
(no devices), or a ``DeviceMesh`` from ``launch/mesh.py``.  ``block``
cuts a rank's block of a tensor by its spec, the part
``jax.device_put`` with a ``NamedSharding`` plays in the reference.
Only the MoE's expert weights (and their AdamW moments) are cut that
way (``models/moe.py::shard_experts``), and a fleet's lanes are dealt
to hosts by ``host_lanes``; every other spec here describes the layout
the tensor-parallel slice will realise.  The reference's
``named`` and ``host_resident_bytes`` read JAX shardings and have no
counterpart.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Tuple

from repro_torch.utils.pytree import tree_map

# (path regex, trailing-dims spec) — first match wins
_RULES: Tuple[Tuple[str, Tuple], ...] = (
    (r"(^|/)embed$",                     (None, "model")),
    (r"(^|/)lm_head$",                   (None, "model")),
    # attention
    (r"(x?attn)/w[qkv]$",                (None, "model")),
    (r"(x?attn)/wo$",                    ("model", None)),
    # MLA
    (r"wq_a$",                           (None, None)),
    (r"wq_b$",                           (None, "model")),
    (r"wkv_a$",                          (None, None)),
    (r"w[kv]_b$",                        ("model", None, None)),
    # MoE (expert-parallel: expert dim on "model")
    (r"moe/router$",                     (None, None)),
    (r"moe/wi_gate$|moe/wi_up$|moe/wo$", ("model", None, None)),
    # dense MLPs (incl. shared experts)
    (r"wi_gate$|wi_up$|wi$",             (None, "model")),
    (r"(mlp|shared)/wo$",                ("model", None)),
    # SSM
    (r"in_proj$",                        (None, "model")),
    (r"out_proj$",                       ("model", None)),
    (r"conv_w$",                         (None, "model")),
    (r"conv_b$",                         ("model",)),
    (r"A_log$|/D$|dt_bias$",             (None,)),
    # MTP glue
    (r"mtp/proj$",                       (None, None)),
)
EXPERT_LEAF = r"moe/(wi_gate|wi_up|wo)$"


class AbstractMesh:
    """Axis names and sizes, no devices: ``shape`` maps each name to its
    size in mesh order, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, axis_sizes, axis_names):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{len(axis_sizes)} sizes for "
                             f"{len(axis_names)} axis names")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              map(int, axis_sizes)))
        self.size = math.prod(self.shape.values())

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


def abstract_mesh(axis_sizes, axis_names) -> AbstractMesh:
    return AbstractMesh(axis_sizes, axis_names)


def as_abstract(mesh) -> AbstractMesh:
    """The axes of an ``AbstractMesh`` or of a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh
    return AbstractMesh(tuple(mesh.shape), mesh.mesh_dim_names)


def data_axes_of(mesh):
    names = as_abstract(mesh).axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def _n_data(mesh) -> int:
    m = as_abstract(mesh)
    return math.prod(m.shape[a] for a in data_axes_of(m))


def _data_entry(daxes):
    return daxes if len(daxes) > 1 else (daxes[0] if daxes else None)


def map_with_paths(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a nested dict, paths ``/``-joined."""
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v,
                                  f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def _trailing_spec(path: str, leaf) -> Tuple:
    for pat, spec in _RULES:
        if re.search(pat, path):
            return spec
    return (None,) * leaf.ndim  # norms, scalars, biases: replicate


def _full_spec(path: str, leaf, mesh: AbstractMesh, *, fsdp: bool,
               ep_all: bool = False) -> Tuple:
    trailing = _trailing_spec(path, leaf)
    trailing = trailing[-leaf.ndim:] if leaf.ndim else ()
    spec = [None] * (leaf.ndim - len(trailing)) + list(trailing)
    shape = tuple(leaf.shape)
    # serving layout: the expert dim over the WHOLE mesh
    if ep_all and re.search(EXPERT_LEAF, path):
        e_dim = leaf.ndim - 3
        if shape[e_dim] % mesh.size == 0:
            spec = [None] * leaf.ndim
            spec[e_dim] = tuple(mesh.axis_names)
            return tuple(spec)
    # exact divisibility: drop non-dividing "model" assignments and put
    # "model" on another dim where one divides (Qwen's 60 experts on a
    # 16-way axis shard d_ff instead)
    model = mesh.shape.get("model", 1)
    dropped_model = False
    for i, s in enumerate(spec):
        if s == "model" and shape[i] % model != 0:
            spec[i] = None
            dropped_model = True
    if dropped_model:
        for i in reversed(range(leaf.ndim)):
            if spec[i] is None and shape[i] % model == 0 \
               and shape[i] >= model:
                spec[i] = "model"
                break
    if fsdp and leaf.ndim >= 2:
        daxes = data_axes_of(mesh)
        n_data = _n_data(mesh)
        if n_data > 1:
            for i, s in enumerate(spec):
                if s is None and shape[i] % n_data == 0 \
                   and shape[i] >= n_data:
                    spec[i] = _data_entry(daxes)
                    break
    return tuple(spec)


def param_specs(params, mesh, *, fsdp: bool = True, ep_all: bool = False):
    """Spec tree matching ``params``.  ``ep_all``: the serving layout,
    MoE expert dims over every mesh axis where they divide."""
    m = as_abstract(mesh)
    return map_with_paths(lambda path, leaf: leaf_spec(
        path, leaf, m, fsdp=fsdp, ep_all=ep_all), params)


def leaf_spec(path: str, leaf, mesh, *, fsdp: bool = True,
              ep_all: bool = False) -> Tuple:
    """The spec ``param_specs`` gives the leaf at ``path``."""
    return _full_spec(path, leaf, as_abstract(mesh), fsdp=fsdp,
                      ep_all=ep_all)


def opt_state_specs(params, mesh, *, fsdp: bool = True, state=None):
    """Specs of the AdamW state ``{m, v, step}`` (``optim/adamw.py``):
    the moments follow the params; an int8-v ``state``'s ``v_scale``
    tree of scalar scales replicates."""
    ps = param_specs(params, mesh, fsdp=fsdp)
    specs = {"m": ps, "v": ps, "step": ()}
    if state is not None and "v_scale" in state:
        specs["v_scale"] = tree_map(lambda _: (), state["v_scale"])
    return specs


def fleet_specs(tree, mesh):
    """Stacked-fleet layout over a ``("hosts",)`` mesh: the leading device
    axis over "hosts" where it divides; everything else replicates."""
    n = as_abstract(mesh).shape["hosts"]

    def spec(leaf):
        nd = getattr(leaf, "ndim", 0)
        if nd >= 1 and n > 1 and leaf.shape[0] % n == 0:
            return ("hosts",) + (None,) * (nd - 1)
        return (None,) * nd

    return tree_map(spec, tree)


def host_lanes(n_lanes: int, n_hosts: int, h: int) -> range:
    """The lanes of a bucket of ``n_lanes`` devices that host ``h`` of
    ``n_hosts`` owns: the contiguous run ``fleet_specs`` gives it once
    the reference has padded the bucket to a multiple of the host count
    (with copies of lane 0, discarded after the round), padding lanes
    left out.  The last hosts may own fewer lanes, or none."""
    per = -(-n_lanes // n_hosts)
    return range(min(h * per, n_lanes), min((h + 1) * per, n_lanes))


def batch_spec(batch, mesh):
    """Every batch array's leading dim over the data axes (tiny decode
    batches that do not divide replicate)."""
    ax = _data_entry(data_axes_of(mesh))
    n_data = _n_data(mesh)

    def spec(x):
        if x.ndim == 0 or x.shape[0] % n_data != 0:
            return (None,) * x.ndim
        return (ax,) + (None,) * (x.ndim - 1)

    return tree_map(spec, batch)


def cache_specs(cache, mesh, *, batch: int, seq: int):
    """Decode-cache layout: the batch-sized dim over the data axes where
    it divides; then the sequence dim over "model" (over every axis when
    the batch could not be split: the sequence-parallel long-context
    layout).  Head-sized dims replicate."""
    m = as_abstract(mesh)
    daxes = data_axes_of(m)
    n_data = _n_data(m)
    model = m.shape.get("model", 1)
    dax = _data_entry(daxes)
    all_axes = tuple(list(daxes) + ["model"])

    def spec(leaf):
        s = [None] * leaf.ndim
        batch_done = False
        for i, d in enumerate(leaf.shape):
            if d == batch and batch % n_data == 0 and n_data > 1:
                s[i] = dax
                batch_done = True
                break
        for i, d in enumerate(leaf.shape):
            if s[i] is None and d == seq and seq > 1:
                if batch_done and d % model == 0:
                    s[i] = "model"
                elif not batch_done and d % (n_data * model) == 0:
                    s[i] = all_axes
                break
        return tuple(s)

    return tree_map(spec, cache)


def paged_cache_specs(cache, mesh, *, batch_axes, seq_axes):
    """Paged-cache layout (``batch_axes`` / ``seq_axes`` from
    ``models.model.decode_cache_batch_axes`` / ``decode_cache_seq_axes``).
    Pool leaves (seq axis >= 0): ``n_blocks`` over the data axes (each
    rank a contiguous run of block ids: ``serve.paged.PagedAllocator``'s
    shards) and the trailing feature dim over "model" where it divides.
    Slot-resident leaves (seq axis < 0) split ``n_slots`` over the data
    axes.  Non-dividing dims replicate."""
    m = as_abstract(mesh)
    n_data = _n_data(m)
    model = m.shape.get("model", 1)
    dax = _data_entry(data_axes_of(m))

    def spec(leaf, bax, sax):
        s = [None] * leaf.ndim
        if n_data > 1 and leaf.shape[bax] % n_data == 0:
            s[bax] = dax
        if sax >= 0 and model > 1:
            last = leaf.ndim - 1
            if last != bax and s[last] is None \
               and leaf.shape[last] % model == 0 \
               and leaf.shape[last] >= model:
                s[last] = "model"
        return tuple(s)

    return tree_map(spec, cache, batch_axes, seq_axes)


def coordinate(mesh) -> Dict[str, int]:
    """This rank's index along each axis of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def block(x, spec, mesh, coord=None):
    """This rank's block of ``x`` under ``spec``: each dim with axes is
    cut into as many equal blocks as their sizes multiply to, and the
    block at the rank's combined index along them (the first axis
    major) is kept.  ``coord`` ({axis: index}) defaults to the rank's
    own (``coordinate``).  A view of ``x``; a dim that does not divide
    raises."""
    m = as_abstract(mesh)
    coord = coordinate(mesh) if coord is None else coord
    if len(spec) != x.ndim:
        raise ValueError(f"spec {spec} for a {x.ndim}-d tensor")
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n, idx = 1, 0
        for a in axes:
            n, idx = n * m.shape[a], idx * m.shape[a] + coord[a]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"{n} ways ({entry})")
        size = x.shape[dim] // n
        x = x.narrow(dim, idx * size, size)
    return x
