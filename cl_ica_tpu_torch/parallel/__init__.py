"""Data and tensor parallelism over ranks: the port of cl_ica_tpu/parallel.

The JAX package's main scale axis is the batch: a 'data' mesh over which
the batch is row-sharded, parameters replicated, and the InfoNCE
negatives global (the reference's gathered-batch DataParallel loss); a
second 'model' axis (``--mesh-model``) splits the encoder's channels.
Here the mesh is a ``torch.distributed`` process group of one process per
device (NCCL on CUDA, gloo on the CPU), each rank holding B/D rows of a
data axis of D and, on a 2-D mesh, its shards of the model:

  mesh.py        the groups (``make_mesh``, ``make_dp_tp_mesh``, ``data_rows``)
                 and the launcher (``launch``, ``run_mesh``: spawned ranks,
                 or torchrun's)
  collective.py  the losses against the global negatives
                 (``global_negatives``, ``gspmd_safe_loss``), the gradient
                 rule, and the row-sharded image store's gathers
                 (``store_gather_scatter``, ``sharded_store_gather``)
  sharded.py     the training steps of the three drivers, the gradient
                 average, and the placement rule (``tp_param_rule``)
  tensor.py      the channel-parallel model (``tensor_parallel``) and its
                 whole state dicts
  ops/collectives.py (below the kernels' wrappers) the group of the
                 running step and the collectives the norms and the
                 channel-parallel layers call
"""

from .collective import (
    global_negatives,
    gspmd_safe_loss,
    kernel_eligible,
    sharded_store_gather,
    store_gather_scatter,
)
from .mesh import (
    Mesh,
    data_rows,
    launch,
    make_dp_tp_mesh,
    make_mesh,
    mesh_rows,
    run_mesh,
)
from .sharded import (
    average_gradients,
    make_sharded_3dident_sup_step,
    make_sharded_3dident_train_step,
    make_sharded_data_train_step,
    make_sharded_synthetic_train_step,
    pad_rows_to_multiple,
    tp_param_rule,
)
from .tensor import (
    load_whole_optimizer_state,
    load_whole_state_dict,
    tensor_parallel,
    whole_optimizer_state,
    whole_state_dict,
)

__all__ = [
    "Mesh",
    "average_gradients",
    "data_rows",
    "global_negatives",
    "gspmd_safe_loss",
    "kernel_eligible",
    "launch",
    "load_whole_optimizer_state",
    "load_whole_state_dict",
    "make_dp_tp_mesh",
    "make_mesh",
    "make_sharded_3dident_sup_step",
    "make_sharded_3dident_train_step",
    "make_sharded_data_train_step",
    "make_sharded_synthetic_train_step",
    "mesh_rows",
    "pad_rows_to_multiple",
    "run_mesh",
    "sharded_store_gather",
    "store_gather_scatter",
    "tensor_parallel",
    "tp_param_rule",
    "whole_optimizer_state",
    "whole_state_dict",
]
