"""Parameter-server tier: host-RAM sparse tables, the pull prefetcher and
the host-paced training loop — copies of ``paddle_tpu/distributed/ps/``'s
``sparse_table.py``, ``prefetch.py`` and ``host_paced.py`` (pure numpy).
``runtime``, ``rpc`` and ``native_server`` (the multi-node servers and
the in-graph ``distributed_lookup_table``) wait for ROADMAP A7.4."""

from .sparse_table import REGISTRY, SparseTable, TableRegistry
from .prefetch import PullPrefetcher
from .host_paced import SparseFeed, run_host_paced
