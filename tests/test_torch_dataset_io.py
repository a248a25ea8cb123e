"""The port's data plane against the JAX package on the CPU: the slot-file
parser (native and Python), ``InMemoryDataset`` / ``QueueDataset`` with
their shuffles and padding, ``io``'s samplers, collate and ``DataLoader``
(threads, the ``dataloader.worker`` fault site and its retries),
``DeviceLoader(device="cpu")``, ``reader.from_generator`` and the
``TrainerDesc`` config plane, each on the same seeded files and arrays.
Every comparison is exact: the data plane moves integers and copies
floats, it computes nothing.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import importlib

import numpy as np
import pytest
import torch

from paddle_tpu import dataset as jdataset
from paddle_tpu import io as jio
from paddle_tpu import trainer_desc as jtd
from paddle_tpu.resilience.injector import fault_scope as jfault_scope

from paddle_tpu_torch import dataset as tdataset
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import trainer_desc as ttd
from paddle_tpu_torch.resilience.injector import fault_scope

# the modules: the packages' attribute ``reader`` is the classic reader
# decorators' namespace
jreader = importlib.import_module("paddle_tpu.reader")
treader = importlib.import_module("paddle_tpu_torch.reader")

SLOTS = 5


def _write(tmp_path, n_files=3, rows=23, seed=0, ragged=True):
    """Slot files of ``rows`` examples each: label, then per slot 0-3
    feasigns (a slot may be absent from a line); the last file ends with a
    blank line."""
    rng = np.random.RandomState(seed)
    paths = []
    for f in range(n_files):
        lines = []
        for _ in range(rows):
            toks = [str(int(rng.randint(0, 2)))]
            for s in range(SLOTS):
                k = int(rng.randint(0 if ragged else 1, 4))
                if k:
                    toks.append(f"{s}:" + ",".join(
                        str(v) for v in rng.randint(1, 10**6, k)))
            lines.append(" ".join(toks))
        p = tmp_path / f"part-{f}"
        p.write_text("\n".join(lines) + ("\n\n" if f == n_files - 1
                                         else "\n"))
        paths.append(str(p))
    return paths


def _same_feeds(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) and a
    for fa, fb in zip(a, b):
        assert sorted(fa) == sorted(fb)
        for k in fa:
            assert fa[k].dtype == fb[k].dtype, k
            np.testing.assert_array_equal(fa[k], fb[k])


@pytest.mark.parametrize("native", [True, False])
def test_parser_matches_the_reference(tmp_path, native):
    path = _write(tmp_path, n_files=1)[0]
    tp = tdataset._SlotFileParser()
    assert tp.is_native
    got = tp.parse(path, SLOTS) if native else tp._parse_py(path, SLOTS)
    ref = jdataset._SlotFileParser._parse_py(path, SLOTS)
    np.testing.assert_array_equal(got[0], ref[0])
    for s in range(SLOTS):
        np.testing.assert_array_equal(got[1][s], ref[1][s])
        np.testing.assert_array_equal(got[2][s], ref[2][s])
        assert got[2][s].dtype == np.int64


def test_parser_reports_a_bad_line(tmp_path):
    p = tmp_path / "bad"
    p.write_text("1 0:12 zz:3\n")
    with pytest.raises(ValueError, match="parse error"):
        tdataset._SlotFileParser().parse(str(p), SLOTS)


def _dataset(mod, paths, cls="InMemoryDataset", bs=7, pad=False,
             trainer=(0, 1)):
    ds = getattr(mod, cls)(SLOTS)
    ds.set_filelist(paths)
    ds.set_batch_size(bs)
    ds.set_trainer_info(*trainer)
    if pad:
        ds.set_pad_to_max_length(True)
    return ds


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("shuffle", ["none", "local", "global"])
def test_in_memory_dataset_matches_the_reference(tmp_path, pad, shuffle):
    paths = _write(tmp_path)
    feeds = []
    for mod in (jdataset, tdataset):
        ds = _dataset(mod, paths, pad=pad, trainer=(1, 3))
        ds.load_into_memory()
        assert ds.get_memory_data_size() == 69
        if shuffle == "local":
            ds.local_shuffle(seed=4)
        elif shuffle == "global":
            ds.global_shuffle(seed=4)
            assert ds.get_memory_data_size() == 23
        feeds.append(list(ds.batch_iterator(drop_last=shuffle == "none")))
    _same_feeds(*feeds)
    if pad:
        assert len({f["slot_0"].shape[1] for f in feeds[1]}) == 1


def test_missing_file_and_release(tmp_path):
    ds = _dataset(tdataset, [str(tmp_path / "nope")])
    with pytest.raises(FileNotFoundError):
        ds.load_into_memory()
    ds = _dataset(tdataset, _write(tmp_path))
    ds.load_into_memory()
    ds.release_memory()
    assert ds.get_memory_data_size() == 0
    with pytest.raises(ValueError, match="num_slots or slot_names"):
        tdataset.InMemoryDataset()


@pytest.mark.parametrize("drop_last", [False, True])
def test_queue_dataset_streams_like_the_reference(tmp_path, drop_last):
    paths = _write(tmp_path)
    _same_feeds(*[_dataset(m, paths, "QueueDataset", bs=10)
                  .batch_iterator(drop_last=drop_last)
                  for m in (jdataset, tdataset)])
    q = _dataset(tdataset, paths, "QueueDataset")
    for call in (q.load_into_memory, q.local_shuffle, q.global_shuffle):
        with pytest.raises(RuntimeError):
            call()


def test_slot_names_label_and_pad_value(tmp_path):
    paths = _write(tmp_path, n_files=1)
    names = [f"s{i}" for i in range(SLOTS)]
    feeds = []
    for mod in (jdataset, tdataset):
        ds = mod.InMemoryDataset(slot_names=names, label_name="click",
                                 pad_value=-1)
        ds.set_filelist(paths)
        ds.set_batch_size(4)
        ds.load_into_memory()
        feeds.append(ds.batch_iterator())
    _same_feeds(*feeds)


def test_book_fixtures_stay(tmp_path):
    (x, y), = [next(iter(tdataset.uci_housing.train()()))]
    assert x.shape == (13,) and y.shape == (1,)
    assert callable(tdataset.mnist.train)


# ----------------------------------------------------------------- io


def _arrays(seed=0, n=37):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3).astype(np.float32),
            rng.randint(0, 10, n).astype(np.int64))


def _same_tree(x, y):
    if isinstance(x, (tuple, list)):
        assert type(x) is type(y) and len(x) == len(y)
        for u, v in zip(x, y):
            _same_tree(u, v)
    elif isinstance(x, dict):
        assert sorted(x) == sorted(y)
        for k in x:
            _same_tree(x[k], y[k])
    else:
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(x, y)


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        _same_tree(x, y)


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False),
                                               (True, True)])
def test_dataloader_matches_the_reference(workers, shuffle, drop_last):
    out = []
    for mod in (jio, tio):
        ds = mod.TensorDataset(*_arrays())
        out.append(mod.DataLoader(ds, batch_size=5, shuffle=shuffle,
                                  drop_last=drop_last, num_workers=workers,
                                  seed=11))
    assert len(out[0]) == len(out[1])
    _same_batches(*out)


def test_samplers_and_collate_match_the_reference():
    x, y = _arrays(n=12)
    for jm, tm in ((jio, tio),):
        jd, td = jm.TensorDataset(x, y), tm.TensorDataset(x, y)
        assert list(tm.SequenceSampler(td)) == list(jm.SequenceSampler(jd))
        assert list(tm.RandomSampler(td, seed=3)) == \
            list(jm.RandomSampler(jd, seed=3))
        bs_t = tm.BatchSampler(td, shuffle=True, batch_size=5, seed=2)
        bs_j = jm.BatchSampler(jd, shuffle=True, batch_size=5, seed=2)
        assert list(bs_t) == list(bs_j) and len(bs_t) == len(bs_j) == 3
        assert len(tm.BatchSampler(td, batch_size=5, drop_last=True)) == 2
    samples = [{"a": (np.ones(2) * i, i), "b": np.arange(3) + i}
               for i in range(4)]
    _same_batches([tio.default_collate_fn(samples)],
                  [jio.default_collate_fn(samples)])
    with pytest.raises(ValueError):
        tio.TensorDataset(np.ones(3), np.ones(4))
    with pytest.raises(ValueError):
        tio.BatchSampler()


class _Stream:
    def __init__(self, mod, n=11):
        self.cls = type("S", (mod.IterableDataset,), {
            "__iter__": lambda s: iter(
                [np.full(2, i, np.float32) for i in range(n)])})

    def make(self):
        return self.cls()


@pytest.mark.parametrize("batch_size,drop_last", [(4, False), (4, True),
                                                  (None, False)])
def test_iterable_dataset_matches_the_reference(batch_size, drop_last):
    _same_batches(*[m.DataLoader(_Stream(m).make(), batch_size=batch_size,
                                 drop_last=drop_last) for m in (jio, tio)])
    with pytest.raises(TypeError):
        len(tio.DataLoader(_Stream(tio).make()))
    with pytest.raises(ValueError):
        tio.DataLoader(_Stream(tio).make(),
                       batch_sampler=tio.BatchSampler(range(3)))


def test_worker_fault_site_retries_injected_faults_like_the_reference():
    """``dataloader.worker:error@1`` fails the second item once; the
    retry policy replays it, so every batch arrives, in order, in both
    packages."""
    out = []
    for mod, scope in ((jio, jfault_scope), (tio, fault_scope)):
        ds = mod.TensorDataset(*_arrays())
        with scope("dataloader.worker:error@1"):
            out.append(list(mod.DataLoader(ds, batch_size=4,
                                           num_workers=2)))
    _same_batches(*out)


def test_a_real_worker_error_fails_fast():
    class Bad(tio.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise KeyError("row 5")
            return np.float32(i)

    with pytest.raises(KeyError, match="row 5"):
        list(tio.DataLoader(Bad(), batch_size=2, num_workers=2))


def test_device_loader_on_the_cpu_passes_batches_through(monkeypatch):
    batches = [{"ids": np.arange(6).reshape(2, 3)}, (np.ones(2),)]
    dl = tio.DeviceLoader(batches, depth=2, device="cpu")
    out = list(dl)
    assert len(out) == 2 and all(a is b for a, b in zip(out, batches))
    with pytest.raises(NotImplementedError, match="A5"):
        tio.DeviceLoader(batches, mesh=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tio.DeviceLoader(batches)


def test_from_generator_matches_the_reference():
    def gen():
        for i in range(3):
            yield {"x": np.full(2, i)}

    out = []
    for mod in (jreader, treader):
        loader = mod.from_generator(feed_list=None, capacity=4)
        with pytest.raises(ValueError, match="set_batch_generator"):
            iter(loader)
        out.append(list(loader.set_batch_generator(gen)))
        assert mod.DataLoader.from_generator(capacity=2) is not None
    _same_batches(*out)
    assert callable(treader.shuffle)


@pytest.mark.parametrize("opt_info", [
    None, {"use_ps": True}, {"fetch_var_names": ["loss"], "thread_num": 4},
    {"fetch_var_names": ["a", "b"], "fetch_info": ["A", "B"],
     "print_period": 7, "use_ps": True}])
def test_trainer_factory_matches_the_reference(opt_info):
    t = ttd.TrainerFactory().create_trainer(opt_info)
    j = jtd.TrainerFactory().create_trainer(opt_info)
    assert type(t).__name__ == type(j).__name__
    assert type(t._device_worker).__name__ == \
        type(j._device_worker).__name__
    for f in ("_fetch_vars", "_fetch_info", "_print_period", "_thread_num",
              "_infer"):
        assert getattr(t, f) == getattr(j, f), f


def test_trainer_desc_setters():
    t = ttd.MultiTrainer()
    t.set_thread(3)
    t.set_infer(True)
    t.set_device_worker(ttd.DownpourSGD())
    t.set_fetch_var_and_info(["x"], ["X"], 5)
    assert (t._thread_num, t._infer, t._device_worker.name,
            t._print_period) == (3, True, "DownpourSGD", 5)
    assert isinstance(ttd.DistMultiTrainer()._device_worker, ttd.DownpourSGD)
    w = ttd.Hogwild()
    w._set_fleet_desc({"a": 1})
    assert w._fleet_desc == {"a": 1}
