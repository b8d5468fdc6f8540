"""The process group, the ('data', 'client', 'model') mesh and batch shards.

Counterpart of ``nerve_tpu/parallel/mesh.py``. The JAX package is one
controller over a ``jax.sharding.Mesh`` of devices; the port is many
controllers, one process (rank) each, on ``torch.distributed``. A rank
holds its own shard of every batch and its own slab of every frame, so the
functions here cut a rank's part out of a full tensor (``shard_batch``) and
gather the parts back (``gather_batch``), where the JAX functions place a
global array.

Axes:
  data   — the batch of every training loop (gradients and BatchNorm
           statistics all-reduced over it);
  client — the federated simulation's cohorts;
  model  — height-sharded frame inference (``parallel.spatial``).

The device is explicit. A mesh on ``cuda`` runs on NCCL, one card a rank
(``cuda:LOCAL_RANK``); a mesh on ``cpu`` runs on gloo. The one other layout
is several ranks that share one card, which the caller asks for by name
(``init_distributed("gloo", ..., device="cuda")``): the kernels run on the
card and the collectives move host copies (``parallel.collectives``). No
layout is chosen after a failure: a missing card, a failed NCCL start or a
second NCCL rank on one card raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from nerve_tpu_torch.parallel import collectives

AXES = ("data", "client", "model")
BACKENDS = {"cpu": ("gloo",), "cuda": ("nccl", "gloo")}


def local_device_count() -> int:
    """The devices a mesh can span: the ranks of the process group once one
    is joined, else the cards of this host."""
    if dist.is_initialized():
        return dist.get_world_size()
    return torch.cuda.device_count()


def init_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None,
                     device: str = "cuda") -> torch.device:
    """Join (or build) the process group and return this rank's device.

    ``device="cuda"`` with ``backend="nccl"`` (the default on the card)
    takes card ``LOCAL_RANK`` (else the rank): a rank without a card of its
    own raises, as NCCL refuses two ranks on one card. ``backend="gloo"``
    with ``device="cuda"`` is the shared-card layout: every rank on the
    current card. ``device="cpu"`` runs on gloo. ``init_method``,
    ``world_size`` and ``rank`` default to torchrun's environment
    (``env://``, ``WORLD_SIZE``, ``RANK``). A group that is already up is
    joined as it is, if its backend is the one asked for. The card it picks
    becomes the current CUDA device, which ``make_mesh`` reads."""
    dev_type = torch.device(device).type
    if dev_type not in BACKENDS:
        raise ValueError(f"no mesh on {device!r}: cuda or cpu")
    backend = backend or BACKENDS[dev_type][0]
    if backend not in BACKENDS[dev_type]:
        raise ValueError(f"backend {backend!r} does not run a mesh on {dev_type} "
                         f"(takes {BACKENDS[dev_type]})")
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        if backend == "nccl":
            local = int(os.environ.get("LOCAL_RANK", rank if rank is not None
                                       else os.environ.get("RANK", 0)))
            if local >= torch.cuda.device_count():
                raise RuntimeError(
                    f"NCCL takes one card a rank: local rank {local} of a host with "
                    f"{torch.cuda.device_count()} card(s); ranks that share a card ask "
                    "for backend='gloo', device='cuda'")
            dev = torch.device("cuda", local)
        else:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        torch.empty(0, device=dev)  # the context, before DeviceMesh picks a card
    else:
        dev = torch.device("cpu")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, not {backend}")
    else:
        kw = {} if world_size is None else {"world_size": world_size, "rank": rank}
        dist.init_process_group(backend, init_method=init_method or "env://", **kw)
    return dev


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ``DeviceMesh`` over every rank with the axes ``AXES``, and this
    rank's device."""

    device_mesh: DeviceMesh
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {a: self.device_mesh.size(i) for i, a in enumerate(AXES)}

    def size(self, axis: str) -> int:
        return self.shape[_axis(axis)]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.device_mesh.get_group(_axis(axis))

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.device_mesh.get_local_rank(_axis(axis))


def _axis(axis: str) -> str:
    if axis not in AXES:
        raise ValueError(f"unknown mesh axis {axis!r}; axes are {AXES}")
    return axis


def make_mesh(data: int = -1, client: int = 1, model: int = 1, device: str = "cuda") -> Mesh:
    """A ('data', 'client', 'model') mesh over the ranks of the process group.

    ``data=-1`` absorbs the ranks the other axes leave. A layout the ranks
    do not fill raises: more ranks than the world has, as in the JAX
    package, and also fewer, since every rank of a multi-controller run
    takes a place in the mesh."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.init_distributed first")
    n = dist.get_world_size()
    if data == -1:
        if n % (client * model) != 0:
            raise ValueError(f"{n} devices not divisible by client*model={client * model}")
        data = n // (client * model)
    need = data * client * model
    if need > n:
        raise ValueError(f"mesh {data}x{client}x{model} needs {need} devices, have {n}")
    if need < n:
        raise ValueError(f"mesh {data}x{client}x{model} leaves {n - need} of the {n} ranks "
                         "without a place")
    dev_type = torch.device(device).type
    dev = (torch.device("cuda", torch.cuda.current_device()) if dev_type == "cuda"
           else torch.device(dev_type))
    dm = init_device_mesh(dev.type, (data, client, model), mesh_dim_names=AXES)
    return Mesh(dm, dev)


def best_data_mesh(batch_size: int, device: str = "cuda") -> Mesh:
    """The largest data-parallel mesh whose size divides ``batch_size``."""
    n = local_device_count()
    size = 1
    for d in range(min(n, batch_size), 0, -1):
        if batch_size % d == 0 and d <= n:
            size = d
            break
    return make_mesh(data=size, device=device)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch, mesh: Mesh, axis: str = "data"):
    """This rank's rows of a global batch (a tensor or a dict, list or tuple
    of batch-leading tensors), moved to the mesh's device: the
    multi-controller counterpart of ``device_put`` with the batch sharding."""
    n, i = mesh.size(axis), mesh.index(axis)

    def cut(x):
        x = torch.as_tensor(x)
        if x.shape[0] % n != 0:
            raise ValueError(f"B={x.shape[0]} not divisible by {axis} axis size {n}")
        rows = x.shape[0] // n
        return x[i * rows:(i + 1) * rows].to(mesh.device)

    return _tree_map(cut, batch)


def gather_batch(batch, mesh: Mesh, axis: str = "data"):
    """The global batch from every rank's rows along ``axis`` (the inverse
    of ``shard_batch``), on every rank."""
    group = mesh.group(axis)
    return _tree_map(lambda x: torch.cat(collectives.all_gather(x, group), 0), batch)
