from phyml_tpu_torch.parallel.mesh import (
    make_mesh, pattern_sharding, sharded_engine,
)
