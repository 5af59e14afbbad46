"""paddle_tpu_torch.parallel -- the distributed engine (counterpart of
paddle_tpu/parallel/).

The reference's multi-device stack (NCCL rings, SSA graph executors,
transpiler program rewrites) becomes, in the port, one process per device
started by ``distributed/launch.py``, a ``DeviceMesh`` whose named dims are
the parallelism kinds, and ``torch.distributed`` collectives on each dim's
process group (NCCL on the card, gloo on the CPU).

Dims (any subset, any sizes):
  dp -- data parallel (batch split; ZeRO-1 optimizer-state split)
  pp -- pipeline parallel (stage split; GPipe or 1F1B over ppermute)
  tp -- tensor parallel (Megatron column / row-parallel layers)
  sp -- sequence parallel (Ulysses all-to-all, ring attention)
  ep -- expert parallel (MoE experts split; tokens by all-to-all)

``sharding.ShardingPlan`` is the placement plan (its specs and
fingerprint; the elastic checkpoints read it).  The sharded embedding
(``parallel/embedding.py``), the plan search (``autoplan.py``) and the
static Executor's use of a plan come with ROADMAP.md Queue 1 item 9b.
"""
from . import collective, compress, data_parallel, fleet, mesh, metrics, sharding
from .compress import (
    CommOptions,
    bucket_signature,
    bucketed_all_reduce,
    comm_scope,
    optimized_all_reduce,
    quantize_blockwise,
    dequantize_blockwise,
    sync_gradients,
    wire_bytes,
)
from .data_parallel import (
    DataParallel,
    apply_collective_grads,
    scale_loss,
    shard_batch,
)
from .mesh import (
    DP_AXIS,
    EP_AXIS,
    PP_AXIS,
    SP_AXIS,
    TP_AXIS,
    MeshConfig,
    current_mesh,
    dp_hierarchy,
    get_mesh,
    init_parallel_env,
    mesh_axis_size,
    mesh_fingerprint,
    set_mesh,
)
from .collective import (
    Group,
    all_gather,
    all_reduce,
    all_to_all,
    barrier,
    broadcast,
    get_group,
    new_group,
    recv,
    reduce,
    reduce_scatter,
    scatter,
    send,
)
from .sharding import (
    ShardingPlan,
    ShardingRules,
    infer_sharding,
    shard_layer,
    shard_params,
    shard_pytree,
    unshard,
)
