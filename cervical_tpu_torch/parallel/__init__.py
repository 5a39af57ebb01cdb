"""The parallel layouts over ``torch.distributed`` — port of
``cervical_tpu/parallel/``: the process group and the ('data', 'model')
mesh (data parallelism with global-batch statistics), the fusion model's
tensor-parallel layout, and the GPipe middle-flow pipeline."""

from cervical_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh, data_sharding, replicated_sharding, shard_batch,
    initialize_multihost, local_batch_slice, barrier, initialize_from_cli,
    is_primary, set_data_axis, global_sums,
)
from cervical_tpu_torch.parallel.tp import (  # noqa: F401
    fusion_param_specs, place_params, full_state_dict,
)
from cervical_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_apply, stack_block_params, middle_flow_pipeline,
)
