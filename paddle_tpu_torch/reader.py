"""fluid.reader parity shim — the port's copy of ``paddle_tpu/reader.py``:
the DataLoader surface under its fluid import path
(python/paddle/fluid/reader.py:414). The implementation lives in
:mod:`paddle_tpu_torch.io`; the package attribute ``reader`` stays the
classic reader decorators (``fluid_compat.reader``), as in the
reference."""

from .io import DataLoader, DeviceLoader  # noqa: F401
from .io.dataloader import BatchSampler, default_collate_fn  # noqa: F401


def from_generator(feed_list=None, capacity=2, iterable=True):
    """DataLoader.from_generator-style factory: returns an object with
    set_batch_generator(fn) / __iter__ like the fluid GeneratorLoader."""

    class _GenLoader:
        def __init__(self):
            self._gen = None

        def set_batch_generator(self, generator, places=None):
            self._gen = generator
            return self

        set_sample_list_generator = set_batch_generator

        def __iter__(self):
            if self._gen is None:
                raise ValueError("call set_batch_generator first")
            return iter(self._gen())

    return _GenLoader()


DataLoader.from_generator = staticmethod(
    lambda feed_list=None, capacity=2, iterable=True, **kw:
    from_generator(feed_list, capacity, iterable))


# the classic reader decorators under the same name: importing this
# module rebinds the package attribute ``reader`` to it, which must keep
# serving ``paddle_tpu_torch.reader.shuffle`` (``fluid_compat.reader``)
from .fluid_compat import reader as _compat_reader  # noqa: E402

shuffle = _compat_reader.shuffle
buffered = _compat_reader.buffered
