"""Relational operators. Ported so far: stream compaction, the hash
aggregate (with its group-id assignment) and the sort (``SortKey``,
``sort_permutation``, ``sort_columns``, with the key normalization the
group-by shares); the hash join and distribution follow in later slices of
the port."""
from .compaction import compact_best, compact_mask, compact_sort, compact_values
from .groupby import distinct_small, group_ids, group_ids_multi
from .hash_aggregate import hash_aggregate, segment_reduce
from .sort import SortKey, normalize_key, sort_columns, sort_permutation
