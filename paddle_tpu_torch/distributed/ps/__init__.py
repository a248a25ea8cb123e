"""Parameter-server tier — the counterpart of
``paddle_tpu/distributed/ps/`` (pure numpy on the host): the sparse
tables, the pull prefetcher and the host-paced training loop
(``sparse_table.py``, ``prefetch.py``, ``host_paced.py``), and the
runtime of the in-graph ``distributed_lookup_table``: the communicator
and the role lifecycle (``runtime.py``), the RPC wire with its Python
server and client (``rpc.py``) and the native C++ server
(``native_server.py``)."""

from .sparse_table import REGISTRY, SparseTable, TableRegistry
from . import runtime
from .prefetch import PullPrefetcher
from .host_paced import SparseFeed, run_host_paced
