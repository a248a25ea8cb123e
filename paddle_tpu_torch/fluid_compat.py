"""The ``fluid`` compatibility namespace and the classic reader
combinators — the counterpart of ``paddle_tpu/fluid_compat.py``.

Lets fluid-era programs (the Paddle Book's, python/paddle/fluid/tests/
book/) run against the port with only their import lines changed:
``import paddle_tpu_torch as paddle; fluid = paddle.fluid``. It provides
the places, ``DataFeeder``, ``fluid.Executor(place)``, the functional
reader pipeline (``paddle.batch``, ``paddle.reader.shuffle`` /
``buffered``) and :func:`build_fluid_module`, which assembles ``fluid``
(``layers``, ``optimizer``, ``initializer``, ``ParamAttr``, ``io``,
``nets``, ``regularizer``, the program accessors, ``unique_name``). The
Book's datasets are :mod:`.dataset`.

Places are honoured, where the reference accepts and ignores them (its
XLA owns placement): ``fluid.Executor(CUDAPlace(i))`` runs on card
``i``, ``CPUPlace()`` on the CPU, no place on the card (raising without
one, as the port's Executor does); an executor on ``TPUPlace()``
raises (ROADMAP C).
"""

from __future__ import annotations

import random as _random
import types as _types

import numpy as np


# -- places --------------------------------------------------------------


class CPUPlace:
    def __repr__(self):
        return "CPUPlace"


class CUDAPlace:
    def __init__(self, device_id=0):
        self.device_id = device_id

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"


class TPUPlace:
    def __repr__(self):
        return "TPUPlace"


def is_compiled_with_cuda() -> bool:
    """Whether this torch build has CUDA (the reference's is False)."""
    import torch
    return torch.backends.cuda.is_built()


def _device_of(place):
    """A place as the port's Executor takes it."""
    if place is None:
        return None
    if isinstance(place, CPUPlace):
        return "cpu"
    if isinstance(place, CUDAPlace):
        return f"cuda:{int(place.device_id)}"
    if isinstance(place, TPUPlace):
        raise ValueError(
            "TPUPlace: the port runs on a CUDA card or the CPU; use "
            "CUDAPlace(i) or CPUPlace()")
    return place


class DataFeeder:
    """fluid.DataFeeder parity: a list of sample tuples -> a feed dict.

    Each sample is a tuple aligned with feed_list; samples are stacked
    along a new batch axis. float64 columns of a float32 variable become
    float32; integer columns keep their dtype (int64 ids and labels stay
    int64 for the gathers)."""

    def __init__(self, feed_list, place=None, program=None):
        self.feed_list = feed_list
        self._names = [getattr(v, "name", v) for v in feed_list]
        self._dtypes = [getattr(v, "dtype", "float32") for v in feed_list]
        self._shapes = [list(getattr(v, "shape", []) or [])
                        for v in feed_list]

    def feed(self, iterable):
        cols = list(zip(*iterable))
        out = {}
        for name, dtype, shape, col in zip(self._names, self._dtypes,
                                           self._shapes, cols):
            arr = np.asarray(col)
            if arr.dtype == np.float64 and str(dtype) == "float32":
                arr = arr.astype(np.float32)
            # reshape flat samples to the var's per-sample shape (the
            # reference DataFeeder's LoDTensor shape coercion)
            per = [d for d in shape[1:] if d is not None]
            if per and all(d > 0 for d in per):
                want = int(np.prod(per))
                got = int(np.prod(arr.shape[1:])) if arr.ndim > 1 else 1
                if got == want:
                    arr = arr.reshape([arr.shape[0]] + per)
                elif arr.ndim == 1 and want == 1:
                    arr = arr[:, None]
            elif arr.ndim == 1:
                arr = arr[:, None]
            out[name] = arr
        return out


class _FluidExecutor:
    """fluid.Executor(place) over the port's Executor, on the place's
    device; runs in the global scope unless ``scope`` is given."""

    def __init__(self, place=None):
        from .framework import Executor, global_scope
        self.place = place
        self._exe = Executor(_device_of(place))
        self._scope = global_scope()

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        from .framework import default_main_program
        program = program if program is not None else default_main_program()
        return self._exe.run(program, feed=feed or {},
                             fetch_list=[getattr(v, "name", v)
                                         for v in (fetch_list or [])],
                             scope=scope or self._scope,
                             return_numpy=return_numpy)

    def close(self):
        self._exe.close()


# -- classic functional readers ----------------------------------------


def batch(reader, batch_size, drop_last=False):
    """paddle.batch parity (reader decorator)."""

    def batched():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batched


def _shuffle(reader, buf_size):
    """paddle.reader.shuffle parity (a buffered shuffle from a
    ``Random(0)``, the reference's stream)."""

    def shuffled():
        rng = _random.Random(0)
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                for s in buf:
                    yield s
                buf = []
        rng.shuffle(buf)
        for s in buf:
            yield s

    return shuffled


reader = _types.ModuleType("paddle_tpu_torch.reader_compat")
reader.shuffle = _shuffle
reader.buffered = lambda r, size: r


def build_fluid_module():
    """Assemble the ``fluid`` namespace (lazily, at the first
    ``paddle_tpu_torch.fluid``)."""
    from . import framework_io as _io
    from . import framework as _fw
    from . import initializer, layers, optimizer
    from .framework import (default_main_program, default_startup_program,
                            global_scope, program_guard, unique_name)
    from .param_attr import ParamAttr

    fluid = _types.ModuleType("paddle_tpu_torch.fluid")
    fluid.layers = layers
    fluid.optimizer = optimizer
    fluid.initializer = initializer
    fluid.ParamAttr = ParamAttr
    fluid.Executor = _FluidExecutor
    fluid.CPUPlace = CPUPlace
    fluid.CUDAPlace = CUDAPlace
    fluid.default_main_program = default_main_program
    fluid.default_startup_program = default_startup_program
    fluid.program_guard = program_guard
    fluid.global_scope = global_scope
    fluid.unique_name = unique_name
    fluid.Program = _fw.Program
    fluid.DataFeeder = DataFeeder
    fluid.is_compiled_with_cuda = is_compiled_with_cuda

    io = _types.ModuleType("paddle_tpu_torch.fluid.io")

    def save_inference_model(dirname, feeded_var_names, target_vars,
                             executor, main_program=None, **kw):
        return _io.save_inference_model(
            dirname, feeded_var_names, target_vars,
            getattr(executor, "_exe", executor), main_program,
            scope=getattr(executor, "_scope", None))

    def load_inference_model(dirname, executor, **kw):
        return _io.load_inference_model(
            dirname, getattr(executor, "_exe", executor),
            scope=getattr(executor, "_scope", None))

    io.save_inference_model = save_inference_model
    io.load_inference_model = load_inference_model
    fluid.io = io

    nets = _types.ModuleType("paddle_tpu_torch.fluid.nets")

    def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                             pool_stride, pool_padding=0, pool_type="max",
                             act=None, **kw):
        """fluid.nets.simple_img_conv_pool parity (nets.py:31)."""
        conv = layers.conv2d(input, num_filters=num_filters,
                             filter_size=filter_size, act=act)
        return layers.pool2d(conv, pool_size=pool_size,
                             pool_type=pool_type, pool_stride=pool_stride,
                             pool_padding=pool_padding)

    def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                       conv_filter_size=3, conv_act=None,
                       param_attr=None, conv_with_batchnorm=False,
                       conv_batchnorm_drop_rate=0.0, pool_stride=1,
                       pool_type="max", use_cudnn=True):
        """fluid.nets.img_conv_group parity (nets.py:104): a VGG-style
        conv stack (with optional BN and dropout per conv), then a
        pool."""
        n = len(conv_num_filter)

        def expand(v):
            return v if isinstance(v, (list, tuple)) else [v] * n

        pads = expand(conv_padding)
        ksizes = expand(conv_filter_size)
        bns = expand(conv_with_batchnorm)
        drops = expand(conv_batchnorm_drop_rate)
        tmp = input
        for i in range(n):
            act = conv_act if not bns[i] else None
            tmp = layers.conv2d(tmp, num_filters=conv_num_filter[i],
                                filter_size=ksizes[i], padding=pads[i],
                                act=act, param_attr=param_attr)
            if bns[i]:
                tmp = layers.batch_norm(tmp, act=conv_act)
                if drops[i] > 0:
                    tmp = layers.dropout(tmp, dropout_prob=drops[i])
        return layers.pool2d(tmp, pool_size=pool_size, pool_type=pool_type,
                             pool_stride=pool_stride)

    def sequence_conv_pool(input, num_filters, filter_size, act="sigmoid",
                           pool_type="max", sequence_length=None,
                           param_attr=None, bias_attr=None):
        """fluid.nets.sequence_conv_pool parity (nets.py:193) over the
        padded+lengths sequence design."""
        conv = layers.sequence_conv(
            input, num_filters=num_filters, filter_size=filter_size,
            sequence_length=sequence_length, param_attr=param_attr,
            bias_attr=bias_attr, act=act)
        return layers.sequence_pool(conv, pool_type, sequence_length)

    nets.simple_img_conv_pool = simple_img_conv_pool
    nets.img_conv_group = img_conv_group
    nets.sequence_conv_pool = sequence_conv_pool
    fluid.nets = nets

    regularizer = _types.ModuleType("paddle_tpu_torch.fluid.regularizer")

    def _l2(regularization_coeff=0.0, **kw):
        return optimizer.L2Decay(regularization_coeff)

    def _l1(regularization_coeff=0.0, **kw):
        return optimizer.L1Decay(regularization_coeff)

    regularizer.L2DecayRegularizer = _l2
    regularizer.L1DecayRegularizer = _l1
    regularizer.L2Decay = _l2
    regularizer.L1Decay = _l1
    fluid.regularizer = regularizer
    fluid.core = _types.ModuleType("paddle_tpu_torch.fluid.core")
    fluid.core.CPUPlace = CPUPlace
    fluid.core.CUDAPlace = CUDAPlace
    return fluid
