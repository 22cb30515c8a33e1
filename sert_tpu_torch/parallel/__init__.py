"""Distribution layer: the mesh of ranks, the sharding rule, the sharded
train step and the distributed top-k (port of ``sert_tpu/parallel/``).

  * mesh axes ``("data", "model")`` over torch.distributed ranks, one
    process per card: batches split over ``data`` (DP), the entity axis,
    SERT's only large axis, over ``model`` (TP over the entity matrix);
  * training: each rank runs the step on its rows and its entity block;
    the losses stitch the softmax over ``model`` per block (K5/K6, K1/K2),
    and the gradients sum over the mesh (``parallel/train.py``);
  * scoring: each model rank sweeps its entity block (K3/K4 per shard, or
    the binmax or scan engines) and the winners merge by an all-gather or
    around a ring (``parallel/topk.py``).

A (1, 1) mesh needs no process group: every collective on an axis of size
1 is the identity. ``dryrun`` spawns a gloo world on the CPU and holds the
sharded step and the distributed top-k against one rank.
"""

from sert_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from sert_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_rows,
    shard_state,
    state_shardings,
)
from sert_tpu_torch.parallel.train import make_sharded_train_step  # noqa: F401
from sert_tpu_torch.parallel.topk import distributed_topk  # noqa: F401
