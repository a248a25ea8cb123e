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

The slot datasets of the reference's ``dataset.py`` (``InMemoryDataset``,
``QueueDataset``: file-sharded slot-file ingestion for the PS runtime)
wait for ROADMAP A7.4, with ``io/`` and ``Executor.train_from_dataset``.
"""

from __future__ import annotations

import types as _types
from typing import Optional, Sequence

import numpy as np


class InMemoryDataset:
    """fluid.InMemoryDataset: waits for ROADMAP A7.4."""

    def __init__(self, num_slots: Optional[int] = None,
                 slot_names: Optional[Sequence[str]] = None,
                 label_name: str = "label", pad_value: int = 0):
        raise NotImplementedError(
            f"{type(self).__name__} (slot-file ingestion for the PS "
            "runtime) waits for ROADMAP A7.4, with io/ and "
            "Executor.train_from_dataset")


class QueueDataset(InMemoryDataset):
    """fluid.QueueDataset: waits with :class:`InMemoryDataset` (ROADMAP
    A7.4)."""


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
