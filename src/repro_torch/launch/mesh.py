"""Device meshes of the port, over ``torch.distributed``.

Counterpart of ``repro.launch.mesh``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with dims ``("data",
"model")`` over the process group that is already initialised: one
rank per device of the reference's mesh, rank r at coordinate
``(r // model, r % model)``, where ``jax.make_mesh`` puts device r.

The device decides the backend: NCCL for ``cuda`` (rank r on
``cuda:{LOCAL_RANK}``), gloo for ``cpu``.  Without a process group, or
with a group of the other backend, the constructors raise: a mesh never
falls back to another backend or device.  ``init_process_group`` starts
the group from ``torchrun``'s ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``
(``env://`` rendezvous), or as one rank over an in-process store when
they are not set.

``make_fleet_mesh`` lays a federated fleet over ``("hosts",)``: one
rank a simulated host (``federated/device.py::train_fleet``).
``make_production_mesh`` (the reference's (16, 16) and multi-pod
meshes) is not ported yet.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
AXES = ("data", "model")


def decode_mesh_shape(n_devices: int):
    """(data, model) split for ``make_decode_mesh``: halve the device
    count into "model" until the data residue is odd (8 -> (2, 4), 4 ->
    (2, 2), 2 -> (1, 2), 6 -> (3, 2), 1 -> (1, 1)).  Pure math, so the
    layout is testable without the devices to back it."""
    d, model = n_devices, 1
    while model < d and d % 2 == 0:
        model *= 2
        d //= 2
    return d, model


def _device_type(device) -> str:
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no mesh on device type {kind!r}; "
                         f"one of {sorted(BACKENDS)}")
    return kind


def local_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` for the card, else the
    CPU."""
    if _device_type(device) == "cuda":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device("cpu")


def init_process_group(device="cuda") -> bool:
    """Join or start the process group that serves ``device``.  An
    initialised group is kept (checked against the device's backend);
    else ranks come from ``RANK`` / ``WORLD_SIZE`` (``env://``, as
    ``torchrun`` sets them), or, without them, one rank over an
    in-process store.  Returns True iff this call started the group (the
    caller then ends it with ``dist.destroy_process_group``)."""
    kind = _device_type(device)
    if dist.is_initialized():
        _check_group(kind)
        return False
    if kind == "cuda":
        torch.cuda.set_device(local_device(kind))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(BACKENDS[kind], init_method="env://")
    else:
        dist.init_process_group(BACKENDS[kind], store=dist.HashStore(),
                                rank=0, world_size=1)
    return True


def _check_group(kind: str) -> None:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group "
                           "(launch.mesh.init_process_group)")
    backend = str(dist.get_backend())
    if BACKENDS[kind] not in backend:
        raise RuntimeError(f"a {kind} mesh needs the {BACKENDS[kind]} "
                           f"backend; the process group runs {backend}")


def _make(shape, device) -> "dist.device_mesh.DeviceMesh":
    from torch.distributed.device_mesh import init_device_mesh
    kind = _device_type(device)
    _check_group(kind)
    world = dist.get_world_size()
    if shape[0] * shape[1] != world:
        raise ValueError(f"mesh {tuple(shape)} needs {shape[0] * shape[1]} "
                         f"ranks; the process group has {world}")
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=AXES)


def make_host_mesh(device="cuda"):
    """(1, world) over every rank (tests / examples)."""
    return _make((1, dist.get_world_size() if dist.is_initialized() else 0),
                 device)


def make_fleet_mesh(n_hosts=None, device="cuda"):
    """1-D ``("hosts",)`` mesh over the first ``n_hosts`` ranks of the
    process group (default: every rank), one rank a simulated host of a
    multi-host fleet (``federated/device.py::train_fleet``).  A rank past
    ``n_hosts`` is outside the mesh: it owns no lanes and receives every
    upload.  More hosts than ranks raise ``ValueError``, the reference's
    oversubscription check, also before any group exists (one rank)."""
    from torch.distributed.device_mesh import DeviceMesh
    kind = _device_type(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_hosts is None else int(n_hosts)
    if not 1 <= n <= world:
        raise ValueError(f"fleet mesh wants {n} hosts but the process group "
                         f"has {world} rank(s) (torchrun --nproc-per-node N "
                         "starts N)")
    _check_group(kind)
    return DeviceMesh(kind, list(range(n)), mesh_dim_names=("hosts",))


def make_decode_mesh(n_devices=None, device="cuda"):
    """(data, model) mesh shaped for serving decode: the model axis gets
    as many ranks as ``decode_mesh_shape`` gives it (it carries the
    expert all-to-all).  ``n_devices`` defaults to the world size and
    must equal it.  The (1, 1) mesh computes what ``mesh=None`` does."""
    _check_group(_device_type(device))
    n = dist.get_world_size() if n_devices is None else n_devices
    return _make(decode_mesh_shape(n), device)
