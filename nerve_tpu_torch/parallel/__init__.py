"""The multi-device paths on ``torch.distributed``.

Counterpart of ``nerve_tpu/parallel``: a ('data', 'client', 'model') mesh
over the ranks of a process group (``mesh``), data parallelism for the
training loops (``training.make_sr_train_step(..., mesh=)``: batch shards,
global BatchNorm statistics, averaged gradients) and height-sharded frame
inference with a halo exchange (``spatial``). The collectives that stand in
for ``lax.ppermute`` and ``lax.psum`` are in ``collectives``; ``launch``
runs a function in N spawned ranks, ``dryrun`` is the twin of the JAX
package's ``__graft_entry__.dryrun_multichip``.
"""

from nerve_tpu_torch.parallel.mesh import (  # noqa: F401
    AXES,
    Mesh,
    best_data_mesh,
    gather_batch,
    init_distributed,
    local_device_count,
    make_mesh,
    shard_batch,
)
from nerve_tpu_torch.parallel.spatial import (  # noqa: F401
    gather_rows,
    shard_rows,
    spatial_lightweight_apply,
    spatial_sr_apply,
    spatial_streaming_apply,
)
