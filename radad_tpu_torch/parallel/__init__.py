"""The mesh on ``torch.distributed`` (counterpart: ``radad_tpu/parallel``)."""

from radad_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, INDEX_AXIS, make_mesh, batch_sharding, index_sharding,
    replicated,
)
from radad_tpu_torch.parallel.sharded_index import (  # noqa: F401
    ShardedIndex, ShardedRetrieval, sharded_retrieve,
)
from radad_tpu_torch.parallel.train_step import (  # noqa: F401
    make_parallel_train_step,
)
from radad_tpu_torch.parallel.tp import (  # noqa: F401
    shard_encoder_params, encoder_param_specs,
)
