from volxel_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from volxel_tpu_torch.parallel.multihost import (  # noqa: F401
    initialize_multihost,
    process_info,
)
from volxel_tpu_torch.parallel.shard import (  # noqa: F401
    render_sample_sharded,
    sharded_render_fn,
)
