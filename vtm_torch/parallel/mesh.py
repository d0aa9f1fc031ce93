"""Process groups and the ('data', 'model') mesh (port of ``vtm/parallel/mesh.py``).

``vtm`` runs one controller process over a ``jax.sharding.Mesh`` and lets
XLA insert the collectives. The port keeps PyTorch's idiom:

  * one process per device (``vtm_torch.parallel.launch``, or torchrun);
  * ``torch.distributed`` with an explicit process group
    (``init_distributed``: ``INIT_METHOD``, ``NUM_SHARDS``, ``SHARD_ID``, or
    torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``);
  * a ``DeviceMesh`` with the dims named ``("data", "model")`` as in
    ``vtm`` (``make_mesh``): rank r sits at data index r // model and model
    index r % model, the layout of ``vtm``'s ``reshape(-1, model_parallel)``;
  * DDP over the ``data`` group and the Megatron collectives over the
    ``model`` group (``vtm_torch/parallel/sharding.py``).

``data_width`` is ``vtm``'s rule for the data axis, a pure function of
(devices, batch, model_parallel): the largest divisor of the batch that
fits the visible devices. ``vtm`` applies it when it builds the mesh; here
the processes exist before the mesh, so the launcher applies it when it
picks the devices (``mesh_devices``, with ``vtm``'s warning when devices
are left idle), and ``make_mesh`` checks that the world it finds fits the
batch.

Collectives used here and in the other modules of this package are
all-reduce, broadcast and all-gather only: gloo supports those on CUDA
tensors, and not reduce-scatter.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# every process group gets a timeout: a collective that one rank never
# joins fails after it instead of hanging
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def data_width(devices: int, batch: int, model_parallel: int = 1) -> int:
    """The data axis ``vtm``'s ``make_mesh(batch_cap=batch)`` builds over
    ``devices`` devices: the largest divisor of ``batch`` that fits
    ``devices // model_parallel``."""
    avail = max(1, devices // max(1, model_parallel))
    return max(d for d in range(1, avail + 1) if batch % d == 0)


def mesh_devices(devices: Sequence, batch: int, model_parallel: int = 1) -> list:
    """The leading devices a mesh for ``batch`` uses, ``data_width`` x
    ``model_parallel`` of them; logs ``vtm``'s warning when some are left
    idle."""
    devices = list(devices)
    mp = max(1, model_parallel)
    if len(devices) < mp:
        raise ValueError(
            f"TPU.MODEL_PARALLEL {mp} needs {mp} devices a data replica; {len(devices)} visible"
        )
    ways = data_width(len(devices), batch, mp)
    used = ways * mp
    if used < len(devices):
        logger.warning(
            "batch size %d caps the data axis at %d of %d available "
            "device(s) — %d device(s) left idle (pick a batch "
            "divisible by the device count to use them all)",
            batch, ways, max(1, len(devices) // mp), len(devices) - used,
        )
    return devices[:used]


def backend_for(dist_backend: str) -> str:
    """``DIST_BACKEND`` -> the torch.distributed backend: ``"ici"`` (the
    default the config shares with ``vtm``) and ``"nccl"`` mean NCCL,
    ``"gloo"`` gloo. Nothing picks gloo by itself."""
    name = str(dist_backend).lower()
    if name in ("ici", "nccl"):
        return "nccl"
    if name == "gloo":
        return "gloo"
    raise ValueError(f"DIST_BACKEND {dist_backend!r}: expected 'nccl' (or 'ici') or 'gloo'")


def _init_method(init_method: str) -> str:
    """``INIT_METHOD`` as torch takes it: "" is the environment
    ("env://"), a bare host:port a TCP address; a URL stays as it is."""
    if not init_method:
        return "env://"
    return init_method if "://" in init_method else f"tcp://{init_method}"


def init_distributed(
    cfg,
    local_rank: int = 0,
    local_size: int = 1,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> bool:
    """Join this process to the job's default process group; returns
    whether there is one.

    The reference's launch topology (``--num_shards/--shard_id/--init_method``,
    as ``vtm``'s ``init_distributed`` maps it) with one process per device:
    ``local_size`` processes on each of ``NUM_SHARDS`` machines, world size
    ``NUM_SHARDS * local_size``, rank ``SHARD_ID * local_size + local_rank``,
    rendezvous at ``init_method`` or else ``INIT_METHOD`` ("" is "env://").
    Under torchrun (``RANK`` and ``WORLD_SIZE`` set) its rank, world size and
    "env://" are taken instead. A one-process run is a no-op unless
    ``init_method`` is given (the launcher gives one, so that a world of
    one still has a group). ``backend`` defaults to ``DIST_BACKEND``'s."""
    if dist.is_initialized():
        return True
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world, rank, method = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]), "env://"
    else:
        world = cfg.NUM_SHARDS * local_size
        rank = cfg.SHARD_ID * local_size + local_rank
        if world <= 1 and init_method is None:
            return False
        method = _init_method(init_method if init_method is not None else cfg.INIT_METHOD)
    dist.init_process_group(
        backend=backend or backend_for(cfg.DIST_BACKEND),
        init_method=method,
        world_size=world,
        rank=rank,
        timeout=timeout,
    )
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the ('data', 'model') mesh. Without a
    process group it is the one-process mesh: widths 1, no groups."""

    data: int = 1
    model: int = 1
    rank: int = 0
    device_mesh: Optional[object] = None  # torch.distributed.device_mesh.DeviceMesh

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def data_group(self):
        return None if self.device_mesh is None else self.device_mesh.get_group("data")

    @property
    def model_group(self):
        return None if self.device_mesh is None else self.device_mesh.get_group("model")

    @property
    def rank_path(self) -> tuple:
        """What a per-step generator's seed path gains: the data rank where
        the batch is split, so that the ranks of one model group draw alike
        and data ranks draw apart; nothing otherwise (the one-process seeds)."""
        return (self.data_rank,) if self.data > 1 else ()


def make_mesh(
    model_parallel: int = 1, batch_cap: Optional[int] = None, device_type: str = "cuda"
) -> Mesh:
    """The mesh over the default process group: ``world / model_parallel``
    data ranks of ``model_parallel`` model ranks each. Without a group it
    is the one-process mesh, and ``model_parallel`` > 1 raises: the cuts
    need that many processes. ``batch_cap`` must be divisible by the data
    width (the launcher sizes the world by ``data_width``)."""
    mp = max(1, int(model_parallel))
    if not dist.is_initialized():
        if mp > 1:
            raise ValueError(
                f"TPU.MODEL_PARALLEL {mp} needs {mp} processes a data replica: run the entry "
                "point's main (vtm_torch.parallel.launch), or torchrun"
            )
        return Mesh()
    world = dist.get_world_size()
    if world % mp:
        raise ValueError(f"{world} processes are not divisible by TPU.MODEL_PARALLEL {mp}")
    data = world // mp
    if batch_cap is not None and batch_cap % data:
        raise ValueError(
            f"batch size {batch_cap} is not divisible by the {data}-way data axis; "
            "choose a divisible batch size or launch fewer processes"
        )
    from torch.distributed.device_mesh import init_device_mesh

    device_mesh = init_device_mesh(device_type, (data, mp), mesh_dim_names=("data", "model"))
    return Mesh(data=data, model=mp, rank=dist.get_rank(), device_mesh=device_mesh)


def entry_device(device, what: str, batch: int, model_parallel: int = 1) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    CUDA device of this process. A machine without one raises. So does a
    process outside a group that sees more CUDA devices than it would use
    alone: the entry point's main launches one process per device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} needs a CUDA device and found none")
    if not dist.is_initialized():
        n = torch.cuda.device_count()
        if n > 1 and data_width(n, batch, model_parallel) > 1:
            raise RuntimeError(
                f"{what}: {n} CUDA devices are visible and the batch of {batch} would use "
                f"{data_width(n, batch, model_parallel)}: run the entry point's main "
                "(one process per device), or pass device= to run on one"
            )
        return torch.device("cuda")
    return torch.device("cuda", torch.cuda.current_device())


def _split_rows(x, mesh: Mesh):
    n = x.shape[0]
    if n % mesh.data:
        raise ValueError(f"{n} rows are not divisible by the {mesh.data}-way data axis")
    per = n // mesh.data
    return x[mesh.data_rank * per:(mesh.data_rank + 1) * per]


def shard_batch(mesh: Mesh, tree):
    """This data rank's contiguous block of rows of a global batch (arrays
    or tensors, in dicts, lists and tuples); the batch itself when the data
    width is 1."""
    if mesh.data == 1:
        return tree
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v) for v in tree)
    return _split_rows(tree, mesh)


def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` broadcast from global rank 0,
    in place (the tensor-parallel cuts start from one full model)."""
    if mesh.device_mesh is None or mesh.world == 1:
        return module
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


def pad_to_multiple(x: np.ndarray, multiple: int):
    """Pad the leading axis up to a multiple (uneven final eval batches
    can't shard across the mesh otherwise). Returns (padded, n_valid)."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad = np.repeat(x[:1], rem, axis=0)
    return np.concatenate([x, pad], axis=0), n


def process_allgather(tree, group=None):
    """All-gather across the processes of ``group`` (the default group when
    None), in rank order: a tensor, or a tuple of them, concatenated along
    its leading axis (equal shapes on every rank); any other host tree by
    ``all_gather_object``, as the list of every rank's. Identity without a
    group or in a group of one."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return tree
    n = dist.get_world_size(group)
    if isinstance(tree, tuple) and all(isinstance(t, torch.Tensor) for t in tree):
        return tuple(process_allgather(t, group) for t in tree)
    if isinstance(tree, torch.Tensor):
        parts = [torch.empty_like(tree) for _ in range(n)]
        dist.all_gather(parts, tree.contiguous(), group=group)
        return torch.cat(parts)
    out = [None] * n
    dist.all_gather_object(out, tree, group=group)
    return out


def all_mean(values: Sequence[float], group, device: torch.device) -> list:
    """The mean over the ranks of ``group`` of each value (each rank's
    values weighted alike: equal rows a rank). Identity without a group."""
    if group is None or dist.get_world_size(group) == 1:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=device)
    dist.all_reduce(t, group=group)
    return (t / dist.get_world_size(group)).tolist()


def all_max(value: float, device: torch.device) -> float:
    """The largest ``value`` over the default group's ranks."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _concat_rows(parts):
    """Concatenate per-rank host rows: arrays, lists, dicts of them."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: _concat_rows([p[k] for p in parts]) for k in first}
    if isinstance(first, list):
        return [x for p in parts for x in p]
    return np.concatenate([np.asarray(p) for p in parts])


def _take_rows(x, n: int):
    if isinstance(x, dict):
        return {k: _take_rows(v, n) for k, v in x.items()}
    return x[:n]


def gather_rows(mesh: Mesh, logits, batch: dict):
    """A data-parallel eval batch made whole: every data rank's logits (a
    tensor, or the verb / noun pair) and host fields (``batch`` less its
    frames), in global row order, without the padding rows, as fp32 numpy
    arrays and the fields a one-process batch has. ``batch["valid"]`` is how
    many of this rank's rows are real (``BatchLoader`` with ``world`` > 1)."""
    group = mesh.data_group
    gathered = process_allgather(logits, group)
    host = {k: v for k, v in batch.items() if k != "frames"}
    hosts = process_allgather(host, group)
    per = (logits[0] if isinstance(logits, tuple) else logits).shape[0]
    keep = np.concatenate([np.arange(r * per, r * per + h["valid"]) for r, h in enumerate(hosts)])

    def rows(t):
        return t.float().cpu().numpy()[keep]

    out = tuple(rows(t) for t in gathered) if isinstance(gathered, tuple) else rows(gathered)
    fields = _concat_rows([_take_rows({k: v for k, v in h.items() if k != "valid"}, h["valid"])
                           for h in hosts])
    return out, fields
