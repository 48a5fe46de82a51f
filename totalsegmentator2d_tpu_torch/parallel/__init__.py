"""Multi-rank execution on ``torch.distributed``: meshes over the ranks,
sharding rules, stacked ensembles, the multi-process runtime and the
collectives the sharded programs use. SPMD over processes: every rank
runs the same call on its own device, and the caller sees the reference
package's semantics (whole results on every rank, the global loss)."""

from .distributed import (distribute_batch, global_mesh, init_distributed,
                          is_distributed, local_shard,
                          predict_cohort_distributed, process_shard,
                          replicate)
from .ensemble import (ensemble_forward, ensemble_forward_sharded,
                       merge_multilabel, pad_head, split_group_outputs,
                       stack_groups)
from .mesh import auto_axes, make_mesh, named
from .sharding import batch_sharding, param_shardings, shard_params

__all__ = ['ensemble_forward', 'ensemble_forward_sharded', 'merge_multilabel',
           'pad_head', 'split_group_outputs', 'stack_groups', 'auto_axes',
           'make_mesh', 'named', 'batch_sharding', 'param_shardings',
           'shard_params', 'init_distributed', 'is_distributed',
           'process_shard', 'global_mesh', 'distribute_batch', 'replicate',
           'local_shard', 'predict_cohort_distributed']
