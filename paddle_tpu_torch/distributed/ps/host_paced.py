"""Host-paced parameter-server training loop — a copy of
``paddle_tpu/distributed/ps/host_paced.py`` (pure numpy).

The reference DownpourWorker's step structure (downpour_worker.cc:726):
FillSparseValue (pull rows into a dense var) -> forward/backward ->
push_sparse_grad from the grad var. The three phases run on the HOST
around one executor step: the sparse rows are pulled from the table tier
before the step and fed as DENSE inputs (on the card, one host-to-device
copy into the captured step's feed buffer), and the rows' gradients come
back as fetched ``@GRAD`` outputs and are pushed after. Nothing inside
the step touches the host, so the step replays as one CUDA graph.

Overlap: batches stream through ``PullPrefetcher``, so batch k+1's PS
round-trip rides under batch k's device step."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from .prefetch import PullPrefetcher
from .sparse_table import REGISTRY


class SparseFeed:
    """One host-paced sparse input: rows of ``table_name`` for the ids
    in ``ids_key`` are fed as ``feed_var`` and their gradient is pushed
    back from ``feed_var + "@GRAD"``."""

    def __init__(self, feed_var: str, table_name: str, value_dim: int,
                 ids_key: str = "ids", init: str = "random",
                 lr: float = 0.1):
        self.feed_var = feed_var
        self.table_name = table_name
        self.value_dim = int(value_dim)
        self.ids_key = ids_key
        self.init = init
        self.lr = lr

    @property
    def grad_var(self) -> str:
        return self.feed_var + "@GRAD"

    def table(self):
        return REGISTRY.get_or_create(self.table_name, self.value_dim,
                                      lr=self.lr, init=self.init)


def run_host_paced(exe, program, scope, batches: Iterable[dict],
                   sparse_feeds: Sequence[SparseFeed],
                   fetch_list: Sequence[str],
                   prefetch_depth: int = 2,
                   on_step=None,
                   collect: bool = True) -> List[List[np.ndarray]]:
    """Drive the pull → compute → push loop over ``batches`` (dicts of
    feed arrays containing each SparseFeed's ids_key). Returns the
    per-step fetches (grad fetches excluded); with ``collect=False``
    only the LAST step's fetches are kept — use that (plus
    ``on_step(i, fetches)`` for streaming metrics) on unbounded batch
    streams, where retaining every step's arrays would grow without
    limit."""
    feeds = list(sparse_feeds)
    for sf in feeds:
        sf.table()          # materialize before the prefetcher looks up
    table_ids = {sf.table_name: (lambda b, k=sf.ids_key: b[k])
                 for sf in feeds}
    fetch_all = list(fetch_list) + [sf.grad_var for sf in feeds]
    out: List[List[np.ndarray]] = []
    n_user = len(fetch_list)
    for i, batch in enumerate(PullPrefetcher(batches, table_ids,
                                             depth=prefetch_depth)):
        feed = dict(batch)
        for sf in feeds:
            ids = np.asarray(batch[sf.ids_key])
            feed[sf.feed_var] = sf.table().pull(ids)   # staged hit
        res = exe.run(program, feed=feed, fetch_list=fetch_all,
                      scope=scope)
        for sf, grad in zip(feeds, res[n_user:]):
            sf.table().push(np.asarray(batch[sf.ids_key]),
                            np.asarray(grad))
        step_out = [np.asarray(r) for r in res[:n_user]]
        if collect:
            out.append(step_out)
        else:
            out = [step_out]
        if on_step is not None:
            on_step(i, step_out)
    return out


__all__ = ["SparseFeed", "run_host_paced"]
