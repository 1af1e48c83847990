"""Scale-out (port of avvad_tpu/parallel): device meshes, placements,
process groups, and the data- and tensor-parallel pieces of the train,
evaluation and serving paths.

The JAX package annotates shardings and lets XLA insert the collectives;
here a collective program runs one ``torch.distributed`` rank a mesh
position (``initialize_multihost``, ``spawn``), and the port adds the
collectives itself: the gradient sum over ``data``, the batch statistics
of the layers that reduce over the batch (``sync``), the metrics, and the
gather of the column-sharded LSTM weights over ``model``. The multi-stream
servers shard their streams over a mesh's data devices in one process.
``dryrun.dryrun_multichip`` is the counterpart of the JAX package's
multi-chip dry run.
"""

from .distributed import (initialize_multihost, local_batch_slice,
                          make_multihost_mesh, spawn)
from .mesh import (Mesh, Placement, batch_rows, batch_sharding, make_mesh,
                   opt_sharding_tree, param_sharding_rules, replicated,
                   shard_batch, shard_opt_state, shard_params, sharding_tree)

__all__ = ["Mesh", "Placement", "batch_rows", "batch_sharding", "initialize_multihost",
           "local_batch_slice", "make_mesh", "make_multihost_mesh", "opt_sharding_tree",
           "param_sharding_rules", "replicated", "shard_batch", "shard_opt_state",
           "shard_params", "sharding_tree", "spawn"]
