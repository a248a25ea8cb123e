"""The classic reader datasets of the Paddle Book — the port's own copy
of the seven fixtures in ``paddle_tpu/fluid_compat.py`` (``:155-430``):
``uci_housing``, ``mnist``, ``imikolov``, ``cifar``, ``conll05``,
``movielens`` and ``wmt14``, each a namespace of reader creators as
``paddle.dataset.<name>`` is in the reference.

They are deterministic synthetic stand-ins (the programs that read them
need the training dynamics, not the real rows), made by the same numpy
``RandomState`` calls as the reference's, so they yield its rows bit for
bit. The sequence datasets follow the padded+lengths design: fixed-width
int64 id windows, with the true length beside them where a row has one.

The slot datasets are the port's copy of the reference's ``dataset.py``
(``InMemoryDataset``, ``QueueDataset``: file-sharded slot-file ingestion
for the PS runtime, read by ``Executor.train_from_dataset``). Files parse
in the native C++ DataFeed (``native/slot_datafeed.cpp``, built at the
first parse) where ``g++`` exists, with the reference's pure-Python parse
beside it; the same CSR-per-slot output either way (``is_native`` says
which ran). ``local_shuffle`` permutes with ``RandomState(seed)`` and
``global_shuffle`` keeps ``example_id % trainer_num == trainer_id`` and
then shuffles locally, the reference's numpy streams, so both packages
order a corpus the same way.
"""

from __future__ import annotations

import ctypes
import os
import types as _types
from typing import Dict, List, Optional, Sequence

import numpy as np


class _SlotFileParser:
    """CSR-per-slot parse of one slot file (see slot_datafeed.cpp for the
    line format: ``label slot:feasign[,feasign...] ...``)."""

    def __init__(self):
        # imported here: ``import paddle_tpu_torch`` loads this module and
        # stays light (the native package pulls in the analyses' locks)
        from .native import build_and_load
        self.lib = build_and_load("slot_datafeed")
        if self.lib is not None:
            L = self.lib
            L.sf_parse.restype = ctypes.c_void_p
            L.sf_parse.argtypes = [ctypes.c_char_p, ctypes.c_int]
            L.sf_error.restype = ctypes.c_char_p
            L.sf_error.argtypes = [ctypes.c_void_p]
            L.sf_num_examples.restype = ctypes.c_int64
            L.sf_num_examples.argtypes = [ctypes.c_void_p]
            L.sf_labels.restype = ctypes.POINTER(ctypes.c_float)
            L.sf_labels.argtypes = [ctypes.c_void_p]
            L.sf_slot_size.restype = ctypes.c_int64
            L.sf_slot_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
            L.sf_slot_offsets.restype = ctypes.POINTER(ctypes.c_int64)
            L.sf_slot_offsets.argtypes = [ctypes.c_void_p, ctypes.c_int]
            L.sf_slot_values.restype = ctypes.POINTER(ctypes.c_int64)
            L.sf_slot_values.argtypes = [ctypes.c_void_p, ctypes.c_int]
            L.sf_free.argtypes = [ctypes.c_void_p]

    @property
    def is_native(self) -> bool:
        return self.lib is not None

    def parse(self, path: str, num_slots: int):
        """-> (labels [n], offsets {slot: [n+1]}, values {slot: [nnz]})"""
        if self.lib is not None:
            h = self.lib.sf_parse(path.encode(), num_slots)
            try:
                err = self.lib.sf_error(h)
                if err:
                    raise ValueError(
                        f"slot file parse error: {err.decode()}")
                n = self.lib.sf_num_examples(h)
                labels = np.ctypeslib.as_array(
                    self.lib.sf_labels(h), shape=(n,)).copy()
                offsets, values = {}, {}
                for s in range(num_slots):
                    nnz = self.lib.sf_slot_size(h, s)
                    offsets[s] = np.ctypeslib.as_array(
                        self.lib.sf_slot_offsets(h, s),
                        shape=(n + 1,)).copy()
                    values[s] = (np.ctypeslib.as_array(
                        self.lib.sf_slot_values(h, s),
                        shape=(nnz,)).copy() if nnz else
                        np.zeros(0, np.int64))
                return labels, offsets, values
            finally:
                self.lib.sf_free(h)
        return self._parse_py(path, num_slots)

    @staticmethod
    def _parse_py(path: str, num_slots: int):
        labels: List[float] = []
        offs = {s: [0] for s in range(num_slots)}
        vals: Dict[int, List[int]] = {s: [] for s in range(num_slots)}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                toks = line.split()
                labels.append(float(toks[0]))
                for tok in toks[1:]:
                    slot_s, _, ids = tok.partition(":")
                    slot = int(slot_s)
                    if 0 <= slot < num_slots:
                        vals[slot].extend(int(v) for v in ids.split(","))
                for s in range(num_slots):
                    offs[s].append(len(vals[s]))
        return (np.asarray(labels, np.float32),
                {s: np.asarray(offs[s], np.int64) for s in offs},
                {s: np.asarray(vals[s], np.int64) for s in vals})


_parser: Optional[_SlotFileParser] = None


def _get_parser() -> _SlotFileParser:
    global _parser
    if _parser is None:
        _parser = _SlotFileParser()
    return _parser


class InMemoryDataset:
    """fluid.InMemoryDataset parity: set_filelist -> load_into_memory ->
    (local|global)_shuffle -> batch iteration.

    Examples are (label, {slot: int64 feasigns}) with CSR storage.
    ``batch_iterator`` pads each slot to the batch's max length with
    ``pad_value`` and yields a feed dict {slot_name: [b, maxlen] int64,
    label_name: [b, 1] float32} — the masked/padded redesign of the
    reference's LoD batches (SURVEY hard part #1).
    """

    def __init__(self, num_slots: Optional[int] = None,
                 slot_names: Optional[Sequence[str]] = None,
                 label_name: str = "label", pad_value: int = 0):
        if num_slots is None and slot_names is None:
            raise ValueError("need num_slots or slot_names")
        self.slot_names = (list(slot_names) if slot_names is not None
                           else [f"slot_{i}" for i in range(num_slots)])
        self.num_slots = len(self.slot_names)
        self.label_name = label_name
        self.pad_value = int(pad_value)
        self.filelist: List[str] = []
        self.batch_size = 1
        self._trainer_id = 0
        self._trainer_num = 1
        self._pad_to_max = False
        # storage: per example, per slot value arrays
        self._labels: Optional[np.ndarray] = None
        self._examples: List[List[np.ndarray]] = []

    # -- fluid API surface -------------------------------------------------
    def set_filelist(self, filelist: Sequence[str]):
        self.filelist = list(filelist)

    def set_batch_size(self, batch_size: int):
        self.batch_size = int(batch_size)

    def set_trainer_info(self, trainer_id: int, trainer_num: int):
        """RoleMaker hookup for global_shuffle sharding."""
        self._trainer_id, self._trainer_num = int(trainer_id), int(trainer_num)

    def set_pad_to_max_length(self, flag: bool = True):
        """Pad every batch's slots to the corpus-wide max length instead
        of the batch max: static shapes across batches mean the executor
        compiles ONCE (the TPU analog of the reference's bucketed LoD
        batching decision; see SURVEY hard part #1)."""
        self._pad_to_max = bool(flag)

    def load_into_memory(self):
        parser = _get_parser()
        labels_all, examples = [], []
        for path in self.filelist:
            if not os.path.exists(path):
                raise FileNotFoundError(path)
            labels, offs, vals = parser.parse(path, self.num_slots)
            for i in range(len(labels)):
                row = [vals[s][offs[s][i]:offs[s][i + 1]]
                       for s in range(self.num_slots)]
                examples.append(row)
            labels_all.append(labels)
        self._labels = (np.concatenate(labels_all) if labels_all
                        else np.zeros(0, np.float32))
        self._examples = examples

    def get_memory_data_size(self) -> int:
        return len(self._examples)

    def local_shuffle(self, seed: Optional[int] = None):
        rng = np.random.RandomState(seed)
        perm = rng.permutation(len(self._examples))
        self._examples = [self._examples[i] for i in perm]
        self._labels = self._labels[perm]

    def global_shuffle(self, seed: Optional[int] = None):
        """Keep examples whose index hashes to this trainer, then shuffle
        locally — deterministic across trainers given identical filelists
        (each example lands on exactly one trainer)."""
        n = len(self._examples)
        keep = [i for i in range(n)
                if i % self._trainer_num == self._trainer_id]
        self._examples = [self._examples[i] for i in keep]
        self._labels = self._labels[keep]
        self.local_shuffle(seed)

    # -- batch iteration ---------------------------------------------------
    def batch_iterator(self, drop_last: bool = False):
        n = len(self._examples)
        bs = self.batch_size
        end = (n // bs) * bs if drop_last else n
        global_max = None
        if self._pad_to_max:
            global_max = [max((len(r[s]) for r in self._examples),
                              default=1) or 1
                          for s in range(self.num_slots)]
        for lo in range(0, end, bs):
            hi = min(lo + bs, n)
            rows = self._examples[lo:hi]
            feed = {}
            for s, name in enumerate(self.slot_names):
                maxlen = (global_max[s] if global_max is not None
                          else max((len(r[s]) for r in rows),
                                   default=1) or 1)
                arr = np.full((len(rows), maxlen), self.pad_value, np.int64)
                for j, r in enumerate(rows):
                    arr[j, :len(r[s])] = r[s]
                feed[name] = arr
            feed[self.label_name] = \
                self._labels[lo:hi].reshape(-1, 1).astype(np.float32)
            yield feed

    def release_memory(self):
        self._examples, self._labels = [], None


class QueueDataset(InMemoryDataset):
    """Streaming variant (fluid.QueueDataset parity): batches parse file
    by file instead of materializing the whole corpus; shuffle is
    unsupported, as in the reference."""

    def load_into_memory(self):
        raise RuntimeError("QueueDataset streams; use batch_iterator()")

    def local_shuffle(self, seed=None):
        raise RuntimeError("QueueDataset does not support shuffle")

    def global_shuffle(self, seed=None):
        raise RuntimeError("QueueDataset does not support shuffle")

    def batch_iterator(self, drop_last: bool = False):
        parser = _get_parser()
        pending_rows: List[List[np.ndarray]] = []
        pending_labels: List[float] = []

        def flush(rows, labels):
            feed = {}
            for s, name in enumerate(self.slot_names):
                maxlen = max((len(r[s]) for r in rows), default=1) or 1
                arr = np.full((len(rows), maxlen), self.pad_value, np.int64)
                for j, r in enumerate(rows):
                    arr[j, :len(r[s])] = r[s]
                feed[name] = arr
            feed[self.label_name] = np.asarray(
                labels, np.float32).reshape(-1, 1)
            return feed

        for path in self.filelist:
            labels, offs, vals = parser.parse(path, self.num_slots)
            for i in range(len(labels)):
                pending_rows.append(
                    [vals[s][offs[s][i]:offs[s][i + 1]]
                     for s in range(self.num_slots)])
                pending_labels.append(labels[i])
                if len(pending_rows) == self.batch_size:
                    yield flush(pending_rows, pending_labels)
                    pending_rows, pending_labels = [], []
        if pending_rows and not drop_last:
            yield flush(pending_rows, pending_labels)


def _uci_housing_rows(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 13).astype(np.float32)
    true_w = np.random.RandomState(7).randn(13, 1).astype(np.float32) * 4.0
    y = x @ true_w + 2.0 + rng.randn(n, 1).astype(np.float32) * 0.1
    return [(x[i], y[i]) for i in range(n)]


def _make_uci_housing():
    mod = _types.ModuleType("paddle_tpu_torch.dataset.uci_housing")

    def train():
        def r():
            for s in _uci_housing_rows(400, seed=0):
                yield s
        return r

    def test():
        def r():
            for s in _uci_housing_rows(100, seed=1):
                yield s
        return r

    mod.train = train
    mod.test = test
    return mod


def _mnist_rows(n, seed):
    # class-separable synthetic digits: class k lights up block k
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        label = int(rng.randint(0, 10))
        img = rng.rand(784).astype(np.float32) * 0.1
        img[label * 70:(label + 1) * 70] += 0.9
        out.append((img * 2 - 1, label))  # reference normalizes to [-1,1]
    return out


def _make_mnist():
    mod = _types.ModuleType("paddle_tpu_torch.dataset.mnist")

    def train():
        def r():
            for s in _mnist_rows(2000, seed=0):
                yield s
        return r

    def test():
        def r():
            for s in _mnist_rows(400, seed=1):
                yield s
        return r

    mod.train = train
    mod.test = test
    return mod


def _make_imikolov():
    """PTB n-gram fixture: a 3rd-order markov chain over a small vocab,
    so the (N-1)-gram genuinely predicts the next word (the book's
    word2vec loss can then actually fall)."""
    mod = _types.ModuleType("paddle_tpu_torch.dataset.imikolov")
    VOCAB = 200

    def build_dict(min_word_freq=50):
        return {f"w{i}": i for i in range(VOCAB)}

    def _stream(n, count, seed):
        # deterministic successor table: next depends on prev word
        succ = np.random.RandomState(3).randint(0, VOCAB, (VOCAB, 4))

        def r():
            # reseed per invocation: readers must replay identically on
            # every pass (the classic paddle reader contract)
            rng = np.random.RandomState(seed)
            w = list(rng.randint(0, VOCAB, n - 1))
            for _ in range(count):
                nxt = int(succ[w[-1], rng.randint(0, 4)])
                yield tuple(w[-(n - 1):]) + (nxt,)
                w.append(nxt)
        return r

    def train(word_dict, n):
        return _stream(n, 2000, seed=0)

    def test(word_dict, n):
        return _stream(n, 200, seed=1)

    mod.build_dict = build_dict
    mod.train = train
    mod.test = test
    return mod


def _make_cifar():
    """cifar.train10 fixture: class-separable 3x32x32 blobs."""
    mod = _types.ModuleType("paddle_tpu_torch.dataset.cifar")

    def _rows(n, seed):
        rng = np.random.RandomState(seed)
        for _ in range(n):
            label = int(rng.randint(0, 10))
            img = rng.rand(3 * 32 * 32).astype(np.float32) * 0.2
            img[label * 300:(label + 1) * 300] += 0.8
            yield img, label

    def train10():
        def r():
            yield from _rows(1000, seed=0)
        return r

    def test10():
        def r():
            yield from _rows(200, seed=1)
        return r

    mod.train10 = train10
    mod.test10 = test10
    return mod


_CONLL_WORD, _CONLL_PRED, _CONLL_LABEL, _CONLL_MAXLEN = 120, 20, 17, 12


def _make_conll05():
    """conll05 SRL fixture over the padded+lengths design: each sample is
    8 padded int64 sequences (word, ctx_n2..ctx_p2, predicate-id
    broadcast, mark) + the label sequence + the true length. Labels are
    a deterministic function of (word, mark) so the tagger is learnable."""
    mod = _types.ModuleType("paddle_tpu_torch.dataset.conll05")

    def get_dict():
        w = {f"w{i}": i for i in range(_CONLL_WORD)}
        v = {f"v{i}": i for i in range(_CONLL_PRED)}
        l = {f"l{i}": i for i in range(_CONLL_LABEL)}
        return w, v, l

    def get_embedding():
        return None     # the book loads pretrained vectors; fixture skips

    def _rows(n, seed):
        rng = np.random.RandomState(seed)
        lab_map = np.random.RandomState(5).randint(
            1, _CONLL_LABEL, (_CONLL_WORD, 2))
        for _ in range(n):
            ln = int(rng.randint(4, _CONLL_MAXLEN + 1))
            words = rng.randint(0, _CONLL_WORD, _CONLL_MAXLEN)
            words[ln:] = 0
            pred = int(rng.randint(0, _CONLL_PRED))
            mark_pos = int(rng.randint(0, ln))
            mark = np.zeros(_CONLL_MAXLEN, np.int64)
            mark[mark_pos] = 1
            labels = lab_map[words, mark].astype(np.int64)
            labels[ln:] = 0
            ctx = [np.roll(words, k) for k in (2, 1, 0, -1, -2)]
            yield (words.astype(np.int64), *[c.astype(np.int64)
                                             for c in ctx],
                   np.full(_CONLL_MAXLEN, pred, np.int64), mark,
                   labels, np.int64(ln))

    def test():
        def r():
            yield from _rows(300, seed=0)
        return r

    mod.get_dict = get_dict
    mod.get_embedding = get_embedding
    mod.test = test
    return mod


def _make_movielens():
    """movielens fixture: (user_id, gender, age, job, movie_id,
    category_seq[4], title_seq[4], score) with a planted low-rank
    structure so the regression converges."""
    mod = _types.ModuleType("paddle_tpu_torch.dataset.movielens")
    USERS, MOVIES, CATS, TITLES, JOBS = 100, 80, 10, 50, 8

    def max_user_id():
        return USERS

    def max_movie_id():
        return MOVIES

    def max_job_id():
        return JOBS - 1

    def _rows(n, seed):
        rng = np.random.RandomState(seed)
        u_lat = np.random.RandomState(11).randn(USERS)
        m_lat = np.random.RandomState(12).randn(MOVIES)
        for _ in range(n):
            u = int(rng.randint(1, USERS))
            m = int(rng.randint(1, MOVIES))
            gender = int(rng.randint(0, 2))
            age = int(rng.randint(0, 7))
            job = int(rng.randint(0, JOBS))
            cats = rng.randint(0, CATS, 4).astype(np.int64)
            title = rng.randint(0, TITLES, 4).astype(np.int64)
            score = np.float32(
                3.0 + 1.5 * np.tanh(u_lat[u] * m_lat[m]))
            yield (np.int64(u), np.int64(gender), np.int64(age),
                   np.int64(job), np.int64(m), cats, title, score)

    def train():
        def r():
            yield from _rows(800, seed=0)
        return r

    def test():
        def r():
            yield from _rows(100, seed=1)
        return r

    mod.max_user_id = max_user_id
    mod.max_movie_id = max_movie_id
    mod.max_job_id = max_job_id
    mod.age_table = [1, 18, 25, 35, 45, 50, 56]
    mod.movie_categories = lambda: [f"c{i}" for i in range(CATS)]
    mod.get_movie_title_dict = lambda: {f"t{i}": i for i in range(TITLES)}
    mod.train = train
    mod.test = test
    return mod


def _make_wmt14():
    """seq2seq fixture over the padded design: fixed-length (src, trg,
    trg_next) id windows with a deterministic src->trg mapping so the
    decoder is learnable."""
    mod = _types.ModuleType("paddle_tpu_torch.dataset.wmt14")
    SRC_LEN, TRG_LEN = 8, 6

    def get_dict(dict_size):
        d = {f"w{i}": i for i in range(dict_size)}
        return d, d

    def _rows(n, dict_size, seed):
        rng = np.random.RandomState(seed)
        vocab = min(dict_size, 200)
        tmap = np.random.RandomState(9).randint(2, vocab, vocab)
        for _ in range(n):
            src = rng.randint(2, vocab, SRC_LEN).astype(np.int64)
            trg = np.concatenate([[1], tmap[src[:TRG_LEN - 1]]]) \
                .astype(np.int64)              # <s> + mapped prefix
            trg_next = np.concatenate([trg[1:], [0]]).astype(np.int64)
            yield src, trg, trg_next

    def train(dict_size):
        def r():
            yield from _rows(600, dict_size, seed=0)
        return r

    def test(dict_size):
        def r():
            yield from _rows(100, dict_size, seed=1)
        return r

    mod.get_dict = get_dict
    mod.train = train
    mod.test = test
    return mod


uci_housing = _make_uci_housing()
mnist = _make_mnist()
imikolov = _make_imikolov()
cifar = _make_cifar()
conll05 = _make_conll05()
movielens = _make_movielens()
wmt14 = _make_wmt14()
