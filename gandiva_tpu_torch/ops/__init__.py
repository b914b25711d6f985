"""Relational operators. Ported so far: stream compaction, the hash
aggregate (with its group-id assignment), the sort (``SortKey``,
``sort_permutation``, ``sort_columns``, with the key normalization the
group-by shares) and the hash join (``join``, ``join_multi``,
``join_stream``, ``build_join_table`` / ``probe_chunk``,
``gather_payload``, ``probe_diagnostics``); the distributed operators
over them are in ``gandiva_tpu_torch.parallel``."""
from .compaction import (compact_best, compact_fragnet, compact_mask,
                         compact_sort, compact_values)
from .groupby import distinct_small, group_ids, group_ids_multi
from .hash_aggregate import hash_aggregate, segment_reduce
from .hash_join import (JoinResult, JoinTable, build_join_table,
                        gather_payload, join, join_multi, join_stream,
                        probe_chunk, probe_diagnostics)
from .sort import SortKey, normalize_key, sort_columns, sort_permutation
