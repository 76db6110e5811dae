"""Data parallelism over ranks: the port of cl_ica_tpu/parallel.

The JAX package's one scale axis is the batch: a 'data' mesh over which
the batch is row-sharded, parameters replicated, and the InfoNCE
negatives global (the reference's gathered-batch DataParallel loss). Here
the mesh is a ``torch.distributed`` process group of one process per
device (NCCL on CUDA, gloo on the CPU), each rank holding B/W rows:

  mesh.py        the group (``make_mesh``, ``data_rows``) and the launcher
                 (``launch``, ``run_mesh``: spawned ranks, or torchrun's)
  collective.py  the losses against the global negatives
                 (``global_negatives``, ``gspmd_safe_loss``) and the
                 gradient rule
  sharded.py     the training steps of the three drivers, and the gradient
                 average
  ops/collectives.py (below the kernels' wrappers) the group of the
                 running step and the collectives the norms call

Not ported (ROADMAP A13b): the tensor-parallel model axis
(``--mesh-model``), the row-sharded image store with its uint8
reduce-scatter (each rank keeps the whole store and gathers its rows), and
a captured mesh step (the steps run eagerly).
"""

from .collective import (
    global_negatives,
    gspmd_safe_loss,
    kernel_eligible,
)
from .mesh import (
    Mesh,
    data_rows,
    launch,
    make_mesh,
    run_mesh,
)
from .sharded import (
    average_gradients,
    make_sharded_3dident_sup_step,
    make_sharded_3dident_train_step,
    make_sharded_data_train_step,
    make_sharded_synthetic_train_step,
    pad_rows_to_multiple,
)

__all__ = [
    "Mesh",
    "average_gradients",
    "data_rows",
    "global_negatives",
    "gspmd_safe_loss",
    "kernel_eligible",
    "launch",
    "make_mesh",
    "make_sharded_3dident_sup_step",
    "make_sharded_3dident_train_step",
    "make_sharded_data_train_step",
    "make_sharded_synthetic_train_step",
    "pad_rows_to_multiple",
    "run_mesh",
]
