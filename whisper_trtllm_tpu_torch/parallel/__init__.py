"""Data and tensor parallelism on ``torch.distributed`` (counterpart of
``whisper_trtllm_tpu/parallel``): the mesh, the partition specs and the
cut of a tree, and the collectives the model issues. The zoo's specs
(``gpt_partition_specs``, ``llama_partition_specs``, ``shard_zoo_params``)
come with the causal-LM zoo."""

from whisper_trtllm_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    check_devices,
    current_mesh,
    initialize_distributed,
    make_mesh,
)
from whisper_trtllm_tpu_torch.parallel.partition import (  # noqa: F401
    param_partition_specs,
    shard_params,
)
