"""paddle_tpu_torch.distributed -- the user-facing distributed API
(counterpart of paddle_tpu/distributed/; ref python/paddle/distributed/).
A parity namespace over ``paddle_tpu_torch.parallel``: the collectives
(collective.py:59-:419 of the reference), ParallelEnv, init_parallel_env
and the fleet facade.  ``launch`` is the multi-process entry
(``python -m paddle_tpu_torch.distributed.launch``).  The parameter
server: host sparse tables and communicators (``ps``) and their TCP
transport (``ps_server``)."""
from . import env
from .env import ParallelEnv, get_rank, get_world_size

# The names below live in paddle_tpu_torch.parallel, which imports this
# package's env module: they resolve on first access, so importing
# ``distributed.env`` (the io sampler and the trace do) loads no more.
_FROM_PARALLEL = {
    "init_parallel_env": "mesh",
    "shutdown_parallel_env": "mesh",
    **{name: "collective" for name in (
        "Group", "ReduceOp", "all_gather", "all_reduce", "all_to_all",
        "barrier", "broadcast", "get_group", "new_group", "ppermute", "recv",
        "reduce", "reduce_scatter", "scatter", "send")},
    "alltoall": "collective",
    **{name: "data_parallel" for name in (
        "DataParallel", "apply_collective_grads", "scale_loss")},
    "DistributedStrategy": "fleet",
    "fleet": "fleet",
}


# the parameter server, loaded on first access too
_FROM_HERE = {
    "ps": None, "ps_server": None,
    **{name: "ps" for name in (
        "AsyncCommunicator", "GeoCommunicator", "HalfAsyncCommunicator",
        "HeartBeatMonitor", "LargeScaleEmbedding", "SparseTable",
        "SyncCommunicator")},
    "PSServer": "ps_server", "RemoteSparseTable": "ps_server",
}


def __getattr__(name):
    if name in _FROM_HERE:
        import importlib

        mod = importlib.import_module(
            f"paddle_tpu_torch.distributed.{_FROM_HERE[name] or name}")
        value = mod if _FROM_HERE[name] is None else getattr(mod, name)
        globals()[name] = value
        return value
    if name in _FROM_PARALLEL:
        import importlib

        mod = importlib.import_module(
            f"paddle_tpu_torch.parallel.{_FROM_PARALLEL[name]}")
        value = getattr(mod, "all_to_all" if name == "alltoall" else name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_FROM_PARALLEL) | set(_FROM_HERE))


def spawn(func, args=(), nprocs=1, **kwargs):
    """ref: distributed/spawn.py:231.  As in the JAX package: runs ``func``
    once in this process when ``nprocs`` is 1 and raises otherwise; the
    port's multi-process entry is the launcher (``python -m
    paddle_tpu_torch.distributed.launch --nproc N script.py``), one process
    a device."""
    if nprocs not in (1, None):
        raise NotImplementedError(
            "spawn runs one process; start N processes with "
            "`python -m paddle_tpu_torch.distributed.launch --nproc N "
            "script.py`")
    return func(*args)
