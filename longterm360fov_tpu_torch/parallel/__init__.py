"""Parallelism of the port: data parallelism over ``torch.distributed``
(:mod:`.mesh`, :mod:`.multihost`), sharded serving over a list of devices
(:mod:`.serve`), the launcher of a world of ranks on one host (:mod:`.launch`),
and, on device grids of one process (:mod:`.grid`), sequence parallelism
(:mod:`.sp`), pipeline parallelism (:mod:`.pp`) and tensor parallelism
(:mod:`.tp`)."""

from . import grid, mesh, multihost, pp, serve, sp, tp  # noqa: F401
from .grid import DeviceGrid  # noqa: F401
from .mesh import (  # noqa: F401
    DataMesh,
    make_mesh,
    make_sharded_train_step,
    replicate_state,
    shard_batch,
    train_loop_dp,
)
from .multihost import global_batch, host_local_batch_slice, init_multihost, replicate_global  # noqa: F401
from .pp import make_pp_mesh, pp_apply_fn, pp_decode  # noqa: F401
from .serve import make_sharded_predict_fn  # noqa: F401
from .sp import make_sp_mesh, ring_self_attention, sp_apply_fn, sp_decode  # noqa: F401
from .tp import apply_tp_shardings, tp_apply, tp_apply_fn, tp_param_shardings  # noqa: F401
