"""Relational operators. Ported so far: stream compaction and the hash
aggregate (with its group-id assignment and the sort's key normalization);
the sort, hash join and distribution follow in later slices of the port."""
from .compaction import compact_best, compact_mask, compact_sort, compact_values
from .groupby import distinct_small, group_ids, group_ids_multi
from .hash_aggregate import hash_aggregate, segment_reduce
from .sort import normalize_key
