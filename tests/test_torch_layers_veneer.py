"""The port's fluid.layers veneers (``layers/nn_veneer.py``, the dense
half) against the JAX package on the CPU: the counterparts of
``tests/test_layers_veneer.py`` (its ``test_norm_and_conv_veneers_run``
without the conv half, which waits with the image ops), each program
built by both packages and run by both, plus the veneers those tests
leave out; the breadth test holds the port's names against the JAX
package's, the waiting ones listed.

Tolerances: values within ``1e-6 + 1e-5 |ref|``, normalizations within
``1e-5 + 1e-4 |ref|``; the seeded random builders bit for bit (uniform,
64-bit types off) or to a few ulps (normal, torch's ``erfinv``).
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import jax
import numpy as np

import paddle_tpu.layers as JL
from paddle_tpu.framework import Executor as JExecutor
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import Scope as JScope
from paddle_tpu.framework import program_guard as jguard
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.layers import nn_veneer as jveneer

import paddle_tpu_torch.layers as TL
from paddle_tpu_torch import fluid_compat
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.framework import (Executor, Program, Scope,
                                        program_guard, unique_name)
from paddle_tpu_torch.layers import nn_veneer as tveneer

PKGS = {"jax": (JL, JProgram, jguard, jun, JExecutor, JScope),
        "port": (TL, Program, program_guard, unique_name,
                 lambda: Executor("cpu"), Scope)}
NORM = (1e-5, 1e-4)


def _run(build, feed, runs=1):
    """``build(layers)`` in each package (seeded programs), run ``runs``
    times on one scope; ``{pkg: [outputs of the last run]}``."""
    out = {}
    for name, (L, P, guard, un, E, S) in PKGS.items():
        main, startup = P(), P()
        main.random_seed = startup.random_seed = 5
        with guard(main, startup), un.guard():
            fetch = build(L)
        fetch = fetch if isinstance(fetch, (list, tuple)) else [fetch]
        scope, exe = S(), E()
        exe.run(startup, scope=scope)
        for _ in range(runs):
            res = exe.run(main, feed=feed, fetch_list=[f.name for f in fetch],
                          scope=scope)
        out[name] = [np.asarray(o) for o in res]
    return out


def _same(out, tol=(1e-6, 1e-5)):
    assert len(out["port"]) == len(out["jax"])
    for a, b in zip(out["port"], out["jax"]):
        assert a.shape == b.shape, (a.shape, b.shape)
        if b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a.astype(np.float64),
                                       b.astype(np.float64), atol=tol[0],
                                       rtol=tol[1])
    return out["port"]


def test_unary_and_elementwise_veneers():
    x = np.array([[-2.0, -0.5, 0.5, 30.0]], np.float32)

    def build(L):
        v = L.data("x", [4])
        return [L.clip(v, -1.0, 1.0), L.leaky_relu(v, 0.1), L.relu6(v),
                L.sign(v), L.brelu(v), L.elu(v), L.hard_sigmoid(v),
                L.pow(v, 2.0)]

    clip_o, lrelu, r6, sign_o, brelu_o, _, _, pow_o = _same(
        _run(build, {"x": x}))
    np.testing.assert_allclose(clip_o, [[-1, -0.5, 0.5, 1]])
    np.testing.assert_allclose(lrelu, [[-0.2, -0.05, 0.5, 30.0]],
                               rtol=1e-6)
    np.testing.assert_allclose(r6, [[0, 0, 0.5, 6.0]])
    np.testing.assert_allclose(sign_o, [[-1, -1, 1, 1]])
    np.testing.assert_allclose(brelu_o, [[0, 0, 0.5, 24.0]])
    np.testing.assert_allclose(pow_o, x ** 2)


def test_shape_indexing_veneers():
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)

    def build(L):
        v = L.data("x", [3, 4])
        idx = L.data("i", [1], dtype="int64", append_batch_size=False)
        return [L.shape(v), L.slice(v, [1], [1], [3]), L.unsqueeze(v, [1]),
                L.squeeze(L.unsqueeze(v, [1]), [1]), L.gather(v, idx),
                L.stack([v, v], axis=0)]

    shp, sl, unsq, sq, gat, st = _same(
        _run(build, {"x": x, "i": np.array([1], np.int64)}))
    np.testing.assert_array_equal(shp, [2, 3, 4])
    np.testing.assert_allclose(sl, x[:, 1:3])
    assert unsq.shape == (2, 1, 3, 4) and sq.shape == x.shape
    np.testing.assert_allclose(gat, x[1:2])
    assert st.shape == (2, 2, 3, 4)


def test_l2_normalize_and_smooth_l1():
    x = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    y = np.random.RandomState(1).randn(3, 5).astype(np.float32)

    def build(L):
        a = L.data("x", [5])
        b = L.data("y", [5])
        return [L.l2_normalize(a, axis=1), L.smooth_l1(a, b)]

    l2, sl1 = _same(_run(build, {"x": x, "y": y}))
    np.testing.assert_allclose(l2, x / np.sqrt((x ** 2).sum(1, keepdims=True)),
                               rtol=1e-5)
    d = x - y
    huber = np.where(np.abs(d) < 1.0, 0.5 * d * d, np.abs(d) - 0.5)
    np.testing.assert_allclose(sl1, huber.sum(1, keepdims=True), rtol=1e-5)


def test_norm_veneers_run():
    """``test_norm_and_conv_veneers_run``'s norm half: ``group_norm`` and
    ``instance_norm`` with their default parameters (scale ones, bias
    zeros). Its conv half (``conv2d_transpose``, ``adaptive_pool2d``)
    waits with the image lowerings."""
    img = np.random.RandomState(0).randn(2, 4, 8, 8).astype(np.float32)

    def build(L):
        v = L.data("img", [4, 8, 8])
        return [L.group_norm(v, groups=2), L.instance_norm(v)]

    g, inorm = _same(_run(build, {"img": img}), NORM)
    assert g.shape == img.shape and np.isfinite(g).all()
    np.testing.assert_allclose(inorm.reshape(2, 4, -1).mean(-1), 0.0,
                               atol=1e-5)


def test_scatter_nd_and_where():
    def build(L):
        idx = L.data("idx", [1], dtype="int64")
        upd = L.data("upd", [], dtype="float32")
        return L.scatter_nd(idx, upd, [6])

    (out,) = _same(_run(build, {"idx": np.array([[1], [3], [1]], np.int64),
                                "upd": np.array([10., 20., 5.], np.float32)}))
    np.testing.assert_allclose(out, [0, 15, 0, 20, 0, 0])


def test_py_func_host_op():
    def host_fn(a):
        return a * 3.0 + 1.0

    got = {}
    for name, (L, P, guard, un, E, S) in PKGS.items():
        main, startup = P(), P()
        with guard(main, startup), un.guard():
            x = L.data("x", [4])
            out = main.global_block().create_var("pyfunc_out", shape=[-1, 4])
            out.dtype = "float32"
            L.py_func(host_fn, x, out)
        scope, exe = S(), E()
        exe.run(startup, scope=scope)
        got[name] = np.asarray(exe.run(
            main, feed={"x": np.ones((2, 4), np.float32)},
            fetch_list=["pyfunc_out"], scope=scope)[0])
    np.testing.assert_allclose(got["port"], np.full((2, 4), 4.0))
    np.testing.assert_array_equal(got["port"], got["jax"])


def test_more_dense_veneers_match():
    """The veneers the reference's tests leave out, in one program each
    side: the activations, the elementwise ops, reshaping and indexing,
    the reductions, ``mul``, ``stanh``, ``dice_loss``, ``label_smooth``,
    ``shard_index`` and the LoD identities. (``soft_relu`` reads its
    intermediate's shape, which the reference's builders leave unset, so
    it fails in both packages alike and is left out.)"""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 3, 4).astype(np.float32)
    ids = rng.randint(0, 12, (2, 3)).astype(np.int64)
    probs = rng.rand(2, 5).astype(np.float32)
    lab = rng.randint(0, 5, (2, 1)).astype(np.int64)

    def build(L):
        v = L.data("x", [3, 4])
        i = L.data("ids", [3], dtype="int64")
        p = L.data("p", [5])
        lb = L.data("lab", [1], dtype="int64")
        zero = L.zeros([2, 3, 4], "float32")
        flat = L.reshape(v, [2, 12])
        u0, u1, u2 = L.unstack(v, axis=1)
        pos = L.greater_than(v, zero)
        return [L.swish(v, 1.5), L.hard_swish(v), L.elu(v, 0.5),
                L.clip_by_norm(v, 1.0),
                L.logical_xor(pos, L.less_than(v, L.scale(v, scale=0.5))),
                L.elementwise_pow(L.square(v), L.scale(v, scale=0.5)),
                L.elementwise_mod(i, L.fill_constant([1], "int64", 5)),
                L.elementwise_floordiv(i, L.fill_constant([1], "int64", 4)),
                L.strided_slice(v, [1, 2], [2, 3], [0, 0], [-1, -2]),
                L.expand(v, [1, 2, 1]), L.expand_as(v, L.concat([v, v], 0)),
                L.gather_nd(L.reshape(v, [12, 2]), L.reshape(i, [2, 3, 1])),
                L.scatter(flat, L.fill_constant([1], "int64", 1),
                          L.slice(flat, [0], [0], [1])),
                L.where(pos, v, L.scale(v, scale=0.5)),
                L.pad(flat, [0, 1, 2, 0], 0.5),
                L.pad2d(L.reshape(v, [2, 1, 3, 4]), [1, 0, 0, 2]),
                u0, u2, L.unbind(v, axis=2)[3], L.size(v), L.rank(v),
                L.reduce_all(L.greater_than(v, L.scale(v, scale=2.0)),
                             dim=[1]),
                L.reduce_any(pos, dim=None),
                L.reduce_prod(v, dim=[2], keep_dim=True),
                L.mul(flat, L.fill_constant([12, 2], "float32", 0.25)),
                L.stanh(v), L.sum([v, v]),
                L.label_smooth(p, epsilon=0.2),
                L.dice_loss(L.softmax(p), lb),
                L.shard_index(i, 12, 3, 1),
                L.lod_reset(v), L.lod_append(v, [1]),
                L.merge_selected_rows(v),
                L.get_tensor_from_selected_rows(v)]

    _same(_run(build, {"x": x, "ids": ids, "p": probs, "lab": lab}))


def test_random_and_counter_veneers():
    """The seeded random builders draw the reference's streams (64-bit
    types off); ``autoincreased_step_counter`` counts the runs in the
    scope; ``prelu`` creates its slope as the reference does. (The
    reference's ``uniform_random`` / ``gaussian_random`` veneers take
    their output's dtype from a first input they do not have, so they
    raise in both packages alike and are left out.)"""
    def build(L):
        v = L.data("x", [4])
        return [L.uniform_random_batch_size_like(v, [-1, 3]),
                L.uniform_random_batch_size_like(v, [2, -1], min=0.0,
                                                 max=2.0, output_dim_idx=1),
                L.gaussian_random_batch_size_like(v, [-1, 2], std=0.5),
                L.gaussian_random_batch_size_like(v, [-1, 3], mean=1.0),
                L.autoincreased_step_counter(counter_name="ctr", begin=1),
                L.prelu(v, "all")]

    x = np.random.RandomState(2).randn(3, 4).astype(np.float32)
    with jax.enable_x64(False):
        out = _run(build, {"x": x}, runs=3)
    for k in (0, 1, 4, 5):
        np.testing.assert_array_equal(out["port"][k], out["jax"][k])
    for k in (2, 3):
        np.testing.assert_allclose(out["port"][k], out["jax"][k],
                                   atol=1e-5, rtol=1e-5)
    assert int(out["port"][4][0]) == 3


def test_wrapper_breadth_vs_reference():
    """The port's layers carry every veneer of the JAX package's
    ``nn_veneer`` except the image and detection ones that wait with
    their lowerings (``nn_veneer.WAITING``); so do ``fluid.layers`` and
    ``static.nn``."""
    ref = set(jveneer.__all__)
    have = {n for n in ref if hasattr(TL, n)}
    assert ref - have == set(tveneer.WAITING)
    assert set(tveneer.__all__) == have
    fluid = fluid_compat.build_fluid_module()
    for n in have:
        assert getattr(fluid.layers, n) is getattr(TL, n)
        assert getattr(tstatic.nn, n) is getattr(TL, n)
    assert not any(hasattr(TL, n) for n in tveneer.WAITING)
    for n in ("While", "while_loop", "cond", "case", "switch_case",
              "less_than", "logical_not"):
        assert getattr(fluid.layers, n) is getattr(TL, n)
        assert hasattr(JL, n)
