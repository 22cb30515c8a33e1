"""Process-group start-up (port of ``sert_tpu/parallel/multihost.py``:
``initialize_multihost`` :25; its ``global_mesh`` :46 is
``parallel.mesh.make_mesh`` over the world of ranks).

One process per card: ``torchrun --nproc_per_node n -m sert_tpu_torch
train|query|serve ...`` sets ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``, and :func:`initialize_multihost` reads
them where no argument is given. The backend is NCCL for CUDA devices and
gloo for the CPU. A world of one rank needs none of this: the (1, 1) mesh
runs without a process group.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from sert_tpu_torch.parallel.mesh import local_device
from sert_tpu_torch.utils.logging import get_logger

log = get_logger("multihost")


def launched_world() -> int:
    """The world size a launcher (torchrun) asked for; 1 without one."""
    return int(os.environ.get("WORLD_SIZE", 1))


def initialize_multihost(init_method: Optional[str] = None,
                         world_size: Optional[int] = None,
                         rank: Optional[int] = None,
                         device=None, backend: Optional[str] = None) -> None:
    """``torch.distributed.init_process_group`` once per process, from the
    explicit arguments or torchrun's variables (explicit values win;
    ``init_method`` defaults to ``env://``, which reads ``MASTER_ADDR`` and
    ``MASTER_PORT``). ``backend`` defaults to NCCL on a CUDA ``device``
    (default ``cuda:LOCAL_RANK``) and gloo on the CPU. A no-op where the
    group exists already."""
    if dist.is_initialized():
        return
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    n = int(world_size if world_size is not None
            else os.environ.get("WORLD_SIZE", 1))
    r = int(rank if rank is not None else os.environ.get("RANK", 0))
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method or "env://", world_size=n, rank=r)
    log.info("distributed: rank %d/%d on %s (%s)", r, n, dev,
             dist.get_backend())

