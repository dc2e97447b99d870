"""Data parallelism across processes, one per card (port of
``raft_ncup_tpu/parallel/``): the process world (:mod:`.multihost`), the
mesh that describes it (:mod:`.mesh`); the mesh train and eval steps are
``training.step.make_train_step`` / ``make_eval_step`` with ``mesh=``."""

from raft_ncup_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_sharding,
    collective_stats,
    make_mesh,
    mesh_fingerprint,
    reset_collective_stats,
    resolve_config_mesh,
    shard_batch,
)
from raft_ncup_tpu_torch.parallel.multihost import (  # noqa: F401
    all_reduce_,
    allreduce_sum_across_hosts,
    barrier,
    initialize_distributed,
    is_main_process,
    is_multihost,
)
