from shgvqa_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    global_rows,
    local_rows,
    make_mesh,
    shard_batch,
)
