"""The process mesh (counterpart of paddle_tpu/parallel/mesh.py).

Replaces the reference's communicator topology layer (`NCCLCommContext`'s
ring_id -> communicator map, platform/collective_helper.h:62, and the
launch-time endpoint plumbing, fleet/launch.py:188).  In the JAX package
the topology is a named ``jax.sharding.Mesh`` over the devices one
process drives.  In the port every rank is its own process on one device,
started by ``distributed/launch.py``: the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the job's ranks, its
dims named ``dp`` / ``pp`` / ``ep`` / ``sp`` / ``tp``, and a dim's process
group carries its collectives (NCCL on the card, gloo when the process
asked for the CPU).

Every dim may have a degree above 1; the canonical order (``dp``
outermost, ``tp`` innermost) lays the ranks out, so a ``tp`` group holds
neighbouring ranks.  A group over several dims (``mesh.group(("dp",
"sp"))``) holds the ranks that differ only in those dims.
"""
from __future__ import annotations

import datetime
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core import device as _device
from ..distributed import env as _env

# Canonical hybrid-parallel dim names (order = outermost..innermost).
DP_AXIS = "dp"
PP_AXIS = "pp"
EP_AXIS = "ep"
SP_AXIS = "sp"
TP_AXIS = "tp"
_CANONICAL_ORDER = (DP_AXIS, PP_AXIS, EP_AXIS, SP_AXIS, TP_AXIS)

# how long a collective may wait for its peers before the job fails
_TIMEOUT = datetime.timedelta(minutes=10)

_global_mesh: Optional["Mesh"] = None


class MeshConfig:
    """Declarative hybrid-parallel topology (the analogue of the
    reference's `DistributedStrategy` topology fields).

    Any dim left as 1 is omitted from the mesh.  ``dp=-1`` means "fill with
    whatever ranks remain".  ``devices`` is a sequence of ranks (default:
    every rank of the job).
    """

    def __init__(self, dp: int = -1, pp: int = 1, tp: int = 1, sp: int = 1,
                 ep: int = 1, devices: Optional[Sequence] = None):
        self.dp, self.pp, self.tp, self.sp, self.ep = dp, pp, tp, sp, ep
        self.devices = devices

    def resolve(self) -> Dict[str, int]:
        devices = (self.devices if self.devices is not None
                   else range(_env.get_world_size()))
        n = len(devices)
        sizes = {DP_AXIS: self.dp, PP_AXIS: self.pp, EP_AXIS: self.ep,
                 SP_AXIS: self.sp, TP_AXIS: self.tp}
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if n % fixed != 0:
            raise ValueError(
                f"device count {n} not divisible by requested parallel "
                f"degrees {sizes} (product {fixed})")
        for k, v in sizes.items():
            if v == -1:
                sizes[k] = n // fixed
                fixed = n
        if math.prod(sizes.values()) != n:
            raise ValueError(f"mesh sizes {sizes} do not cover {n} devices")
        return sizes


class Mesh:
    """Named dims over the job's ranks.  ``device`` is this rank's device,
    and ``device_mesh`` the ``DeviceMesh`` whose groups carry the
    collectives; a mesh built before any process group exists has neither
    and sizes only."""

    def __init__(self, axis_names: Tuple[str, ...], shape: Dict[str, int],
                 device: Optional[torch.device] = None, device_mesh=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(shape)
        self.device = device
        self.device_mesh = device_mesh
        self._subgroups: Dict[tuple, tuple] = {}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axes):
        """The process group over ``axes`` (names of this mesh's dims)."""
        if self.device_mesh is None:
            raise RuntimeError(
                "the mesh has no process group: call init_parallel_env() "
                "(or fleet.init()) in each rank first")
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        axes = tuple(a for a in self.axis_names if a in axes)
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        ranks = self.device_mesh.mesh
        dims = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(ranks.dim()) if i not in dims]
        groups = ranks.permute(rest + dims).reshape(
            -1, math.prod(self.shape[a] for a in axes)).tolist()
        return self.enumerated_group(groups)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on dim ``axis`` (0 where the dim is
        absent or the mesh has no process groups)."""
        if axis not in self.axis_names or self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def enumerated_group(self, groups):
        """This rank's process group of a partition of the ranks
        (``groups``: lists of ranks, as the JAX package's
        ``axis_index_groups``).  Every rank creates every group of the
        partition on its first use, in the same order, as
        ``torch.distributed`` requires."""
        key = tuple(tuple(int(r) for r in g) for g in groups)
        if key not in self._subgroups:
            if self.device_mesh is None:
                self.group(DP_AXIS)  # raises without process groups
            mine, _ = dist.new_subgroups_by_enumeration(
                [list(g) for g in key], timeout=_TIMEOUT)
            self._subgroups[key] = mine
        return self._subgroups[key]

    def __repr__(self):
        dims = ", ".join(f"{a}={self.shape[a]}" for a in self.axis_names)
        return f"Mesh({dims}, device={self.device})"


def _rank_device() -> torch.device:
    """This rank's device: the CPU when the process asked for it
    (``set_device("cpu")``), else card ``rank % device_count`` (raising
    where there is no card, as ``core.device`` does)."""
    if isinstance(_device.get_device(), _device.CPUPlace):
        return torch.device("cpu")
    _device.resolve_device("cuda")
    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())


def build_mesh(config: Optional[MeshConfig] = None, **axes) -> Mesh:
    """A Mesh from a MeshConfig or dim sizes (``build_mesh(dp=2)``).  Over
    this job's ranks, once the default process group exists, it carries a
    ``DeviceMesh``; otherwise it holds the sizes only."""
    if config is None:
        config = MeshConfig(**axes) if axes else MeshConfig()
    sizes = config.resolve()
    names = tuple(a for a in _CANONICAL_ORDER if sizes[a] > 1)
    if not names:  # degenerate single-dim mesh so collectives still resolve
        names = (DP_AXIS,)
    shape = {a: sizes[a] for a in names}
    n = math.prod(shape.values())
    if not (dist.is_available() and dist.is_initialized()
            and n == dist.get_world_size()):
        return Mesh(names, shape)
    from torch.distributed.device_mesh import init_device_mesh

    device = _rank_device()
    mesh_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(mesh_type, tuple(shape[a] for a in names),
                          mesh_dim_names=names)
    return Mesh(names, shape, device, dm)


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _global_mesh
    _global_mesh = mesh


def get_mesh() -> Optional[Mesh]:
    return _global_mesh


def current_mesh() -> Mesh:
    """The active mesh, creating a default all-``dp`` mesh on first use."""
    global _global_mesh
    if _global_mesh is None:
        _global_mesh = build_mesh(MeshConfig())
    return _global_mesh


def mesh_axis_size(axis: str, mesh: Optional[Mesh] = None) -> int:
    mesh = mesh or current_mesh()
    return mesh.shape[axis] if axis in mesh.axis_names else 1


def _local_ranks() -> int:
    """Ranks on this rank's host: the launcher's endpoints that share
    ``PADDLE_CURRENT_ENDPOINT``'s host (one process a device), else 1."""
    eps = [e for e in os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")
           if e]
    me = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")
    if not eps or not me:
        return 1
    host = me.rsplit(":", 1)[0]
    return sum(1 for e in eps if e.rsplit(":", 1)[0] == host)


def dp_hierarchy(axis_size: int,
                 local: Optional[int] = None) -> Optional[Tuple[int, int]]:
    """Factor a data-parallel dim of ``axis_size`` members into
    (intra-host, inter-host) group sizes, or None when the dim does not
    span hosts (everything local, or one device per host, or the host size
    does not divide the dim).

    The intra size defaults to the ranks on this host (the JAX package's
    ``jax.local_device_count()``; here a process is one device): devices
    of one host share the fast links, so collectives reduce-scatter there
    before crossing hosts (the InitHierarchicalCtxs two-ring split,
    parallel_executor.cc:209)."""
    if local is None:
        local = _local_ranks()
    local = int(local)
    if local <= 1 or local >= axis_size or axis_size % local:
        return None
    return local, axis_size // local


def mesh_fingerprint(mesh: Optional[Mesh] = None) -> str:
    """Stable fingerprint of a mesh's shape: dim names and sizes plus the
    device platform and kind.  Ranks over equivalent topologies produce the
    same string."""
    mesh = mesh or current_mesh()
    axes = ",".join(f"{a}={mesh.shape[a]}" for a in mesh.axis_names)
    dev = mesh.device
    if dev is None:
        where = "?:?"
    elif dev.type == "cuda":
        where = f"cuda:{torch.cuda.get_device_name(dev)}"
    else:
        where = f"{dev.type}:{dev.type}"
    return f"mesh({axes})x{mesh.size}@{where}"


def _rendezvous() -> str:
    coord = (os.environ.get("PADDLE_COORDINATOR")
             or os.environ.get("PADDLE_MASTER")
             or os.environ.get("MASTER_ADDR", "127.0.0.1") + ":"
             + os.environ.get("MASTER_PORT", "8271"))
    return f"tcp://{coord}"


def init_parallel_env(strategy=None, *, dp: Optional[int] = None, pp: int = 1,
                      tp: int = 1, sp: int = 1, ep: int = 1) -> Mesh:
    """Initialize the distributed environment (ref:
    python/paddle/distributed/parallel.py:32 ``init_parallel_env``) and
    set the global mesh, ``dp`` defaulting to every rank.

    Without a default process group, one is created: NCCL on the card,
    gloo when the process asked for the CPU (``set_device("cpu")``); the
    rank and world come from the launcher's ``PADDLE_TRAINER_ID`` /
    ``PADDLE_TRAINERS_NUM`` and the rendezvous from
    ``PADDLE_COORDINATOR`` (else ``MASTER_ADDR:MASTER_PORT``); a process
    run alone gets a one-member group.  A default group the caller set up
    already is used as it is."""
    del strategy
    if not dist.is_initialized():
        cpu = isinstance(_device.get_device(), _device.CPUPlace)
        if not cpu:
            _device.resolve_device("cuda")  # raises where there is no card
        world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        backend = "gloo" if cpu else "nccl"
        if not cpu:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        if world > 1:
            dist.init_process_group(backend, init_method=_rendezvous(),
                                    rank=rank, world_size=world,
                                    timeout=_TIMEOUT)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, timeout=_TIMEOUT)
    _register_exit_teardown()
    cfg = MeshConfig(dp=-1 if dp is None else dp, pp=pp, tp=tp, sp=sp, ep=ep)
    mesh = build_mesh(cfg)
    set_mesh(mesh)
    return mesh


def _release_groups() -> None:
    """Drop the port's handles on process groups (the global mesh with its
    DeviceMesh and subgroups, the named groups, fleet's mesh), destroy the
    default group and collect, so the groups' C++ destructors join gloo's
    and the store's threads now, while the interpreter is whole."""
    import gc
    import sys

    set_mesh(None)
    coll = sys.modules.get("paddle_tpu_torch.parallel.collective")
    if coll is not None:
        coll._groups.clear()
    fl = sys.modules.get("paddle_tpu_torch.parallel.fleet")
    if fl is not None:
        fl.fleet._mesh = None
    if dist.is_initialized():
        dist.destroy_process_group()
    gc.collect()


def shutdown_parallel_env(barrier: bool = True) -> None:
    """Leave the job in order: every rank waits for the others (a barrier
    on the default group: no rank tears its connections down while a peer
    is still in a collective; ``barrier=False`` skips it for a job whose
    group may be broken), then the groups are destroyed and collected.
    A process group that outlives ``destroy_process_group`` (a mesh still
    referring to it) is destroyed at interpreter exit, where gloo's
    threads may still be joinable and the process aborts ("terminate
    called without an active exception").  A process that set up the
    environment and does not call this gets the release, without the
    barrier, at exit."""
    if barrier and dist.is_initialized():
        dist.barrier()
    _release_groups()


_exit_teardown = [False]


def _register_exit_teardown() -> None:
    if not _exit_teardown[0]:
        import atexit

        atexit.register(_release_groups)
        _exit_teardown[0] = True


def replicated(x, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``x`` on this rank's device, which every rank holds whole."""
    mesh = mesh or current_mesh()
    return torch.as_tensor(x, device=mesh.device)


def data_sharding(mesh: Optional[Mesh] = None,
                  batch_axes: Sequence[str] = (DP_AXIS,),
                  seq_axis: Optional[str] = None) -> tuple:
    """The placement of an input batch as a spec tuple: the leading dim over
    the mesh's batch dims (None when there are none), then the sequence
    dim's, as the JAX package's ``PartitionSpec``.  ``parallel.sharding.
    place(x, spec)`` takes this rank's slice of a batch by it
    (``shard_batch`` does, with ``seq_axis=`` too)."""
    mesh = mesh or current_mesh()
    batch = tuple(a for a in batch_axes if a in mesh.axis_names)
    spec = [batch if batch else None]
    if seq_axis is not None and seq_axis in mesh.axis_names:
        spec.append(seq_axis)
    return tuple(spec)
