"""Scale-out: process groups, the device mesh, parameter placements
(ZeRO-1, FSDP, TP, FSDP x TP), GPipe over a "stage" axis, and the
collectives under them. Counterpart of vqgan_tpu/parallel/."""

from .fsdp import (
    MODES,
    ShardedState,
    apply_fsdp_sharding,
    compose_fsdp_with_tp,
    fsdp_spec_for,
    pin_state_shardings,
    place_state,
    sharding_spec_for,
    state_specs,
)
from .init import (
    barrier,
    initialize_distributed,
    make_global_array,
    process_count,
    process_index,
    process_local_batch_size,
)
from .mesh import (
    Mesh,
    data_sharding,
    is_main_process,
    make_mesh,
    make_mesh_for_batch,
    named_mesh,
    replicate,
    replicated,
    shard_batch,
)
from .pp import (
    make_pipeline_mesh,
    pipeline_apply,
    shard_stacked_params,
    stack_params,
)
from .tp import apply_tp_sharding, tp_spec_for_path

__all__ = ["MODES", "Mesh", "ShardedState", "apply_fsdp_sharding",
           "apply_tp_sharding", "barrier", "compose_fsdp_with_tp",
           "data_sharding", "fsdp_spec_for", "initialize_distributed",
           "is_main_process", "make_global_array", "make_mesh",
           "make_mesh_for_batch", "make_pipeline_mesh", "named_mesh",
           "pin_state_shardings", "pipeline_apply", "place_state",
           "process_count", "process_index", "process_local_batch_size",
           "replicate", "replicated", "shard_batch", "shard_stacked_params",
           "sharding_spec_for", "stack_params", "state_specs",
           "tp_spec_for_path"]
