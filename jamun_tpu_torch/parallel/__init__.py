from jamun_tpu_torch.parallel.mesh import (
    data_parallel_shardings,
    make_mesh,
    pad_batch_to_multiple,
    replicate,
    shard_batch,
)
