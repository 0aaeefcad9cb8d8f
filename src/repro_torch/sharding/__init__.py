from repro_torch.sharding.rules import (param_specs, batch_specs, cache_specs,
                                        batch_axes, local_shape, local_bytes)
from repro_torch.sharding.cohort import (COHORT_AXIS, cohort_mesh, shardable,
                                         sweep_sharding, sweep_shardable,
                                         winner_shardable)
