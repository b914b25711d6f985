"""Distribution layer: a 1-axis partition mesh, the all-to-all shuffle,
skew-aware distributed operators, and pipeline composition (SURVEY.md §2c,
§5.8). Partitions live in one process on one device, or divide over a
``torch.distributed`` group (gloo on the CPU, NCCL across cards)."""
from . import mesh, ops, pipeline, shuffle
from .mesh import (PARTITION_AXIS, Mesh, held, join_group, leave_group,
                   make_mesh, shard, unshard)
from .ops import (detect_hot_keys, dist_hash_aggregate, dist_join,
                  dist_join_skewed, dist_sort)
from .pipeline import (PipelineOverflowError, build_filter_join_agg_sort,
                       measure_scaling_efficiency, measure_weak_scaling,
                       model_ici_efficiency, run_pipeline,
                       run_pipeline_with_retry)
from .shuffle import (bucket_by_partition, exchange, exchange_flat,
                      exchange_sized, flatten_received, shuffle_by_key)
