"""Data parallelism of the port (slice P-1): training over
``torch.distributed`` (:mod:`.mesh`, :mod:`.multihost`), sharded serving over
a list of devices (:mod:`.serve`), and the launcher of a world of ranks on one
host (:mod:`.launch`). Sequence, pipeline and tensor parallelism are slices
P-2 and P-3 (ROADMAP.md)."""

from . import mesh, multihost, serve  # noqa: F401
from .mesh import (  # noqa: F401
    DataMesh,
    make_mesh,
    make_sharded_train_step,
    replicate_state,
    shard_batch,
    train_loop_dp,
)
from .multihost import global_batch, host_local_batch_slice, init_multihost, replicate_global  # noqa: F401
from .serve import make_sharded_predict_fn  # noqa: F401
