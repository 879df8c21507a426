"""The device mesh as a ``torch.distributed`` world, one process a device.

Port of ``defensive_model_vae_tpu/parallel/mesh.py``.  JAX's ``Mesh`` is
one controller over many devices; here the mesh is a process group with one
rank per device, laid out as a ``(data, model)``
``torch.distributed.device_mesh.DeviceMesh`` (rank r at coordinate
``(r // tp, r % tp)``).  Every rank runs the same program on its own block
of the batch (SPMD), and whatever XLA inserted implicitly in JAX is an
explicit collective here: the gradients are all-reduced over the ``data``
group, as DDP does, and results are gathered over it.

The backend is the caller's: NCCL on the card and gloo on the CPU is the
default for a device of that type, and nothing gives way to another backend
when one fails.  Under ``torchrun`` the world comes from ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK`` (rank r on ``cuda:LOCAL_RANK``); with no
process group and no such environment :func:`create_mesh` makes a world of
one, as ``create_mesh()`` on a one-device host does in JAX.

gloo takes CUDA tensors for every collective used here: ``torch.distributed``'s
backend table lists no CUDA ``all_gather`` for gloo, but torch 2.11's gloo
all-gathers them, checked value by value on the card (``chip_smoke.py``'s
``parallel`` phase), so :func:`gather_rows` gathers on the device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a (data, model) mesh.

    ``shape`` is ``{"data": dp, "model": tp}`` as JAX's ``mesh.shape``;
    ``coordinate`` is this rank's (None on a rank outside a mesh over a
    prefix of the world), ``data_index`` its first entry."""

    device_mesh: object  # torch.distributed.device_mesh.DeviceMesh
    device: torch.device
    backend: str
    axis_names: Tuple[str, str]

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.device_mesh.mesh.shape))

    @property
    def size(self) -> int:
        return self.device_mesh.mesh.numel()

    @property
    def coordinate(self):
        return self.device_mesh.get_coordinate()

    @property
    def data_index(self) -> Optional[int]:
        c = self.coordinate
        return None if c is None else c[0]

    @property
    def data_group(self):
        return self.device_mesh.get_group(self.axis_names[0])


def check_mesh(mesh) -> Mesh:
    """``mesh`` itself, or TypeError when it is not a :class:`Mesh`."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a Mesh from parallel.create_mesh, got "
                        f"{type(mesh).__name__}")
    return mesh


def _ensure_world(backend: Optional[str], device) -> torch.device:
    """Join (or make) the default process group → this rank's device."""
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return dev


def create_mesh(n_devices: Optional[int] = None,
                shape: Optional[Tuple[int, int]] = None,
                axis_names: Tuple[str, str] = ("data", "model"),
                backend: Optional[str] = None, device=None) -> Mesh:
    """A (data, model) mesh over the world's ranks (JAX mesh.py:28).

    Defaults to every rank on the data axis (pure data parallelism);
    ``shape=(dp, tp)`` picks a layout, e.g. (4, 2) over 8 ranks.  A mesh of
    fewer devices than the world takes a prefix of the ranks.  ``device``
    (default the card) and ``backend`` (default NCCL for a CUDA device,
    gloo for the CPU) apply where this call makes the process group; an
    existing group is joined as it is."""
    dev = _ensure_world(backend, device)
    have = dist.get_world_size()
    if n_devices is None:
        n_devices = shape[0] * shape[1] if shape is not None else have
    if n_devices > have:
        raise ValueError(f"need {n_devices} devices, have {have}")
    if shape is None:
        shape = (n_devices, 1)
    if shape[0] * shape[1] != n_devices:
        raise ValueError(f"mesh shape {shape} != {n_devices} devices")
    from torch.distributed.device_mesh import DeviceMesh

    dm = DeviceMesh(dev.type, torch.arange(n_devices).reshape(shape),
                    mesh_dim_names=tuple(axis_names))
    return Mesh(dm, dev, dist.get_backend(), tuple(axis_names))


def padded_rows(n: int, mesh: Mesh) -> int:
    """The global row count :func:`shard_batch` pads ``n`` rows to."""
    dp = mesh.shape["data"]
    return -(-n // dp) * dp


def block(n_pad: int, mesh: Mesh) -> slice:
    """This rank's contiguous block of ``n_pad`` rows (``PartitionSpec
    ("data")``'s block of device ``data_index``)."""
    per = n_pad // mesh.shape["data"]
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def shard_batch(batch, mesh: Mesh):
    """This rank's block of the leading (batch) axis (JAX mesh.py:56).

    Pads to a multiple of the data-axis size with copies of row 0 (callers
    that need the unpadded objective mask those rows, as ``train.train``
    does); :func:`padded_rows` gives the padded global count.  Takes and
    returns a torch tensor or a numpy array."""
    n = batch.shape[0]
    n_pad = padded_rows(n, mesh)
    if n_pad != n:
        if isinstance(batch, torch.Tensor):
            batch = torch.cat([batch, batch[:1].expand((n_pad - n,) + batch.shape[1:])])
        else:
            batch = np.concatenate([batch, np.repeat(batch[:1], n_pad - n, axis=0)])
    return batch[block(n_pad, mesh)]


def replicate(tree, mesh: Mesh):
    """The nested dict of tensors ``tree`` as rank 0 holds it, on every rank
    (JAX mesh.py:75): each leaf broadcast from rank 0 into a copy."""
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    out = tree.detach().clone().to(mesh.device).contiguous()
    dist.broadcast(out, src=0)
    return out


def all_reduce_sum(tensors: Sequence[torch.Tensor], group) -> list:
    """Σ over ``group`` of each tensor, in ONE collective: the tensors are
    packed flat into float32, reduced, and cut back to their shapes."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return out


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The data group's equal blocks of ``t`` concatenated in rank order, on
    every rank."""
    dp = mesh.shape["data"]
    if dp == 1:
        return t
    src = t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dp)]
    dist.all_gather(parts, src, group=mesh.data_group)
    return torch.cat(parts)


def run_block(fn, mesh: Mesh):
    """``fn()`` on this rank's block, then one all-reduce over the data
    group of which ranks raised → ``fn()``'s result.  If it raised on any
    rank, every rank raises (its own exception, or a ``RuntimeError`` naming
    the data ranks that failed), so the ranks leave the call together and
    meet again at the same next collective: no rank waits in a gather the
    others never reach.  A data axis of one runs ``fn()`` alone."""
    dp = mesh.shape["data"]
    if dp == 1:
        return fn()
    out, err = None, None
    try:
        out = fn()
    except Exception as e:  # raised again below, once the group knows
        err = e
    failed = torch.zeros(dp, dtype=torch.float32, device=mesh.device)
    if err is not None:
        failed[mesh.data_index] = 1.0
    dist.all_reduce(failed, group=mesh.data_group)
    if err is not None:
        raise err
    if bool(failed.any()):
        ranks = torch.nonzero(failed).flatten().tolist()
        raise RuntimeError(f"data ranks {ranks} of {dp} failed this call")
    return out


def gather_objects(items: list, mesh: Mesh) -> list:
    """The data group's lists concatenated in rank order, on every rank."""
    dp = mesh.shape["data"]
    if dp == 1:
        return list(items)
    parts = [None] * dp
    dist.all_gather_object(parts, items, group=mesh.data_group)
    return [x for p in parts for x in p]


def tensor_shard_params(params, mesh: Mesh, hidden_dim: int = 128):
    """Column-parallel tensor sharding (JAX mesh.py:81): the first axis of
    each leaf equal to ``hidden_dim`` (and divisible by the model-axis size)
    is sharded over the mesh's ``model`` axis as a DTensor; other leaves
    are replicated DTensors.  DTensor's sharding rules insert the
    collectives the forward needs; feed it inputs from
    :func:`model_replicated`."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    tp = mesh.shape["model"]
    sub = mesh.device_mesh[mesh.axis_names[1]]

    def placement(leaf):
        if tp > 1:
            for i, d in enumerate(leaf.shape):
                if d == hidden_dim and d % tp == 0:
                    return [Shard(i)]
        return [Replicate()]

    return {k: {n: distribute_tensor(a.to(mesh.device), sub, placement(a))
                for n, a in v.items()} for k, v in params.items()}


def model_replicated(t: torch.Tensor, mesh: Mesh):
    """``t`` (the same on every rank of the model group) as a replicated
    DTensor over the ``model`` axis, the input form of a sharded forward."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t.to(mesh.device), mesh.device_mesh[mesh.axis_names[1]],
                              [Replicate()])


def make_parallel_train_step(step, mesh: Mesh):
    """Wrap a train step of ``train.make_train_step`` for the mesh (JAX
    mesh.py:106): ``wrapped(params, opt_state, eps, batch, mask=None,
    extra=None)`` takes this rank's blocks of ``eps``/``batch``/``mask``/
    ``extra`` (:func:`shard_batch`) and replicated params and optimizer
    state; the loss is scaled by the global valid-row count, the gradients
    and loss components are all-reduced over the data group, and the
    replicated Adam step keeps the parameters equal on every rank."""

    def wrapped(params, opt_state, eps, batch, mask=None, extra=None):
        local = (torch.tensor(float(batch.shape[0]), device=mesh.device) if mask is None
                 else mask.detach().to(mesh.device, torch.float32).sum())
        (n_valid,) = all_reduce_sum([local.reshape(1)], mesh.data_group)
        return step(params, opt_state, eps, batch, mask, extra,
                    group=mesh.data_group, n_valid=float(n_valid))

    return wrapped
