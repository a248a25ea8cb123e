"""The multi-tensor AdamW kernel's wrapper on the CPU: its plain version
against the per-parameter update and JAX's, an emulation of the
kernel's arithmetic (csrc/adamw.cu, operation by operation in float32)
against the plain version, the chunk plan the kernel walks, the
optimizer's grouping, and the C entry's argument list. The kernel
itself runs only on the card (``chip_smoke.py`` holds it bit-equal to
the plain version there with ``torch.equal``).

``torch.sqrt`` on the CPU is not correctly rounded: it is one ulp off
for about 0.65% of random float32 inputs (6,505 of 1e6 against numpy's
in this environment). CUDA's ``sqrtf``, XLA's and the kernel's
``__fsqrt_rn`` are, so the bit-for-bit tests give the plain version a
correctly rounded square root (float64, rounded to float32, which is
exact for a float32 input, then to a 16-bit input's dtype, as the card
computes a 16-bit square root in float32); the per-parameter comparison
needs none.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import ctypes
import pathlib
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.optimizer_ops import _adamw as jax_adamw
from paddle_tpu_torch.ops import optimizer_ops
from paddle_tpu_torch.ops.cuda import adamw as aw
from paddle_tpu_torch.optimizer import AdamW

SIZES = [1, 7, 4097]
_SQRT = torch.sqrt


@pytest.fixture
def exact_sqrt(monkeypatch):
    monkeypatch.setattr(torch, "sqrt",
                        lambda x: _SQRT(x.double()).float().to(x.dtype))
HYPER = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, coeff=0.01)


def _state(seed, sizes, mdtype, steps_done, pdtype=torch.float32):
    """Parameters, gradients, moments and beta powers after
    ``steps_done`` earlier steps (random moments, powers beta^t), the
    parameters, gradients and powers in ``pdtype``."""
    rng = np.random.RandomState(seed)
    out = []
    for n in sizes:
        p = torch.from_numpy(rng.randn(n).astype(np.float32))
        g = torch.from_numpy((rng.randn(n) * 1e-2).astype(np.float32))
        if steps_done:
            m1 = torch.from_numpy((rng.randn(n) * 1e-3).astype(np.float32))
            m2 = torch.from_numpy((rng.rand(n) * 1e-5).astype(np.float32))
        else:
            m1, m2 = torch.zeros(n), torch.zeros(n)
        b1p = torch.ones(1)
        b2p = torch.ones(1)
        for _ in range(steps_done):
            b1p, b2p = b1p * 0.9, b2p * 0.999
        out.append([p.to(pdtype), g.to(pdtype), m1.to(mdtype),
                    m2.to(mdtype), b1p.to(pdtype), b2p.to(pdtype)])
    return out


def _clone(state):
    return [[t.clone() for t in row] for row in state]


def _cols(state):
    return [list(c) for c in zip(*state)]


def _bits_equal(a, b, what):
    for x, y in zip(a, b):
        for s, t, name in zip(x, y, ("p", "g", "m1", "m2", "b1p", "b2p")):
            assert s.dtype == t.dtype and torch.equal(s, t), (what, name)


@pytest.mark.parametrize("mdtype", [torch.float32, torch.bfloat16])
def test_plain_is_the_per_parameter_update_and_jax(mdtype, exact_sqrt):
    """Three steps of ``adamw_multi_plain`` on a group equal, bit for bit,
    ``ops/optimizer_ops.adamw`` applied to each parameter (moments
    rounded as the optimizer stores them) and the JAX package's
    ``_adamw`` op."""
    group = _state(0, SIZES, mdtype, 0)
    single = _clone(group)
    # copies: jnp.asarray may alias a numpy buffer the plain update then
    # writes in place
    jstate = [[jnp.array(t.float().numpy().copy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
        for t in row] for row in group]
    rng = np.random.RandomState(1)
    for _ in range(3):
        grads = [(rng.randn(n) * 1e-2).astype(np.float32) for n in SIZES]
        for rows, g in zip((group, single), (grads, grads)):
            for row, gi in zip(rows, g):
                row[1] = torch.from_numpy(gi.copy())
        aw.adamw_multi_plain(*_cols(group), 1e-3, **HYPER)
        for row in single:
            new = optimizer_ops.adamw(*row, 1e-3, **HYPER)
            row[0], row[4], row[5] = new[0], new[3], new[4]
            row[2], row[3] = new[1].to(mdtype), new[2].to(mdtype)
        for row, gi in zip(jstate, grads):
            out = jax_adamw(None, {
                "Param": [row[0]], "Grad": [jnp.asarray(gi)],
                "Moment1": [row[2]], "Moment2": [row[3]],
                "Beta1Pow": [row[4]], "Beta2Pow": [row[5]],
                "LearningRate": [jnp.asarray([1e-3], jnp.float32)]},
                {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
                 "coeff": 0.01})
            row[0] = out["ParamOut"][0]
            row[2] = out["Moment1Out"][0].astype(row[2].dtype)
            row[3] = out["Moment2Out"][0].astype(row[3].dtype)
            row[4], row[5] = out["Beta1PowOut"][0], out["Beta2PowOut"][0]
        _bits_equal(group, single, "per-parameter")
        for row, jrow in zip(group, jstate):
            for k in (0, 2, 3, 4, 5):
                got = row[k].float().numpy()
                want = np.asarray(jrow[k].astype(jnp.float32))
                assert got.tobytes() == want.tobytes(), k


def _kernel_emulated(p, g, m1, m2, b1p, b2p, lr, mdtype,
                     pdtype=torch.float32, gscale=None):
    """csrc/adamw.cu's arithmetic, one float32 operation at a time (numpy
    float32 rounds each to nearest, as the _rn intrinsics do), each result
    rounded through torch to the dtype the per-op path's promotion gives
    it: ``R_P`` the parameters', ``R_M`` the moments', ``R_MP`` both
    promoted (exact in float32). ``gscale`` (a float32 value): the
    kernel's ``grad_scale``, ``g = R_P(g * scale)`` first."""
    f = np.float32
    c1, c2, beta1, beta2, omb1, omb2, eps, coeff = (
        f(v) for v in aw.scalars(0.9, 0.999, 1e-8, 0.01, mdtype))
    mpdtype = torch.promote_types(mdtype, pdtype)

    def rounder(dt):
        return lambda x: torch.from_numpy(np.atleast_1d(
            np.asarray(x, np.float32))).to(dt).float().numpy()

    R_P, R_M, R_MP = rounder(pdtype), rounder(mdtype), rounder(mpdtype)
    b1 = R_P(b1p.float().numpy()[0] * beta1)[0]
    b2 = R_P(b2p.float().numpy()[0] * beta2)[0]
    lr = f(lr)
    root = R_P(np.sqrt(R_P(f(1) - b2)))[0]
    lr_t = R_P(R_P(lr * root)[0] / R_P(f(1) - b1)[0])[0]
    decay = f(lr * coeff)
    m1 = m1.float().numpy()
    m2 = m2.float().numpy()
    g = g.float().numpy()
    if gscale is not None:
        g = R_P(g * f(gscale))
    p = p.float().numpy()
    a1, a2 = R_M(m1 * c1), R_M(m2 * c2)
    m1n = R_MP(a1 + R_P(omb1 * g))
    m2n = R_MP(a2 + R_P(R_P(omb2 * g) * g))
    den = R_MP(R_MP(np.sqrt(m2n)) + eps)
    with np.errstate(divide="ignore", invalid="ignore"):
        adam = R_MP(p - R_MP(R_MP(lr_t * m1n) / den))
    pn = R_P(R_MP(adam - R_P(decay * p)))
    return [torch.from_numpy(pn).to(pdtype), None,
            torch.from_numpy(m1n).to(mdtype),
            torch.from_numpy(m2n).to(mdtype),
            torch.tensor([b1]).to(pdtype), torch.tensor([b2]).to(pdtype)]


@pytest.mark.parametrize("steps_done", [0, 9])
@pytest.mark.parametrize("mdtype", [torch.float32, torch.bfloat16])
def test_kernel_arithmetic_is_the_plain_update(mdtype, steps_done,
                                              exact_sqrt):
    """The kernel's sequence of operations, emulated in float32, is
    bit-equal to the plain update at the first step (beta powers 1) and
    a later one."""
    group = _state(2, SIZES + [2 ** 16 + 3], mdtype, steps_done)
    want = [_kernel_emulated(*row, 1e-3, mdtype) for row in group]
    aw.adamw_multi_plain(*_cols(group), torch.tensor([1e-3]), **HYPER)
    for row, w in zip(group, want):
        for k in (0, 2, 3, 4, 5):
            assert row[k].dtype == w[k].dtype
            assert torch.equal(row[k], w[k]), k


@pytest.mark.parametrize("steps_done", [0, 9])
@pytest.mark.parametrize("pdtype,mdtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float16, torch.float16), (torch.float16, torch.float32),
    (torch.float16, torch.bfloat16), (torch.float32, torch.float16)])
def test_kernel_arithmetic_with_16_bit_parameters(pdtype, mdtype, steps_done,
                                                  exact_sqrt):
    """With bf16 or fp16 parameters (a model cast to half precision) the
    per-op path rounds every intermediate to its promoted dtype; the
    kernel's sequence, emulated with the same roundings, is bit-equal to
    the plain update for every pairing of parameter and moment dtypes
    (lr 0.05, so that the rounded steps still move 16-bit parameters)."""
    group = _state(3, SIZES + [2 ** 16 + 3], mdtype, steps_done, pdtype)
    want = [_kernel_emulated(*row, 0.05, mdtype, pdtype) for row in group]
    with np.errstate(divide="ignore", invalid="ignore"):
        aw.adamw_multi_plain(*_cols(group), torch.tensor([0.05]), **HYPER)
    for row, w in zip(group, want):
        for k in (0, 2, 3, 4, 5):
            assert row[k].dtype == w[k].dtype
            assert _same(row[k], w[k]), k


@pytest.mark.parametrize("pdtype,mdtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16), (torch.float16, torch.float32)])
def test_kernel_arithmetic_with_a_grad_scale(pdtype, mdtype, exact_sqrt):
    """With ``grad_scale`` (GradientClipByGlobalNorm's factor, a float32
    [1] tensor) the kernel first rounds ``g * scale`` to the parameters'
    dtype; emulated so, it is bit-equal to the plain version, which
    multiplies as the reference's clip does (the two dtypes promoted) and
    then takes the gradient to the parameters' dtype. A scale in the
    gradients' own dtype (bf16 values) gives the same bits as a float32
    one holding them."""
    scale = torch.tensor([0.3712], dtype=torch.float32).to(pdtype).float()
    group = _state(7, SIZES + [2 ** 16 + 3], mdtype, 9, pdtype)
    want = [_kernel_emulated(*row, 0.05, mdtype, pdtype,
                             gscale=float(scale)) for row in group]
    again = _clone(group)
    with np.errstate(divide="ignore", invalid="ignore"):
        aw.adamw_multi_plain(*_cols(group), torch.tensor([0.05]), **HYPER,
                             grad_scale=scale)
        aw.adamw_multi_plain(*_cols(again), torch.tensor([0.05]), **HYPER,
                             grad_scale=scale.to(pdtype).reshape(()))
    for row, w, r2 in zip(group, want, again):
        for k in (0, 2, 3, 4, 5):
            assert row[k].dtype == w[k].dtype
            assert _same(row[k], w[k]), k
            assert _same(row[k], r2[k]), k


@pytest.mark.parametrize("coeff", [0.01, 0.0])
@pytest.mark.parametrize("steps_done", [0, 9])
def test_kernel_arithmetic_with_float64_parameters(steps_done, coeff,
                                                  monkeypatch):
    """A float64 group (a float64 program's Adam) computes in double with
    the scalars unrounded (beta1 itself, ``1 - beta1`` in double,
    epsilon), the lr rounded to float32 from its float64 slot and the
    decay ``float32(lr) * float32(coeff)``: the kernel's sequence so, in
    numpy float64, is bit-equal to the plain update. The square root is
    numpy's, correctly rounded as ``__dsqrt_rn`` and the card's
    ``torch.sqrt`` are (torch's vectorized CPU sqrt of float64 can be an
    ulp off). The wrapper passes dtype code 3 for the parameters, the
    moments and the lr, and refuses float64 parameters with other
    moments."""
    monkeypatch.setattr(torch, "sqrt", lambda x: torch.from_numpy(
        np.sqrt(x.numpy())) if x.dtype == torch.float64 else _SQRT(x))
    group = _state(11, SIZES + [2 ** 16 + 3], torch.float64, steps_done,
                   torch.float64)
    lr = torch.tensor([1e-3], dtype=torch.float64)
    c1, c2, beta1, beta2, omb1, omb2, eps, cf = aw.scalars(
        0.9, 0.999, 1e-8, coeff, torch.float64)
    assert (c1, beta2, omb1, eps) == (0.9, 0.999, 1 - 0.9, 1e-8)
    assert cf == float(np.float32(coeff))
    want = []
    for p, g, m1, m2, b1p, b2p in group:
        p, g, m1, m2 = (t.numpy() for t in (p, g, m1, m2))
        b1, b2 = b1p.numpy()[0] * beta1, b2p.numpy()[0] * beta2
        l32 = np.float32(lr.numpy()[0])
        lr_t = np.float64(l32) * np.sqrt(1 - b2) / (1 - b1)
        m1n = c1 * m1 + omb1 * g
        m2n = c2 * m2 + omb2 * g * g
        pn = p - lr_t * m1n / (np.sqrt(m2n) + eps)
        if cf:
            pn = pn - np.float64(l32 * np.float32(cf)) * p
        want.append([pn, m1n, m2n, np.array([b1]), np.array([b2])])
    aw.adamw_multi_plain(*_cols(group), lr, beta1=0.9, beta2=0.999,
                         epsilon=1e-8, coeff=coeff)
    for row, w in zip(group, want):
        for k, x in zip((0, 2, 3, 4, 5), w):
            assert row[k].dtype == torch.float64
            assert row[k].numpy().tobytes() == x.tobytes(), k
    p, g, m1, m2, b1p, b2p = _cols(group)
    table = aw.Table(p, m1, m2, b1p, b2p, lr)
    assert (table.param_code, table.moment_code, table.lr_code) == (3, 3, 3)
    args = aw.launch_args(table, g, None,
                          aw.scalars(0.9, 0.999, 1e-8, coeff, torch.float64),
                          None, 0, len(p), 0, sum(table.chunks))
    assert args[-4:-1] == (3, 3, 3)
    aw._check(p, g, m1, m2, b1p, b2p, None, table)
    m32 = [t.float() for t in m1]
    with pytest.raises(TypeError, match="float64 moments"):
        aw._check(p, g, m32, m32, b1p, b2p, None,
                  aw.Table(p, m32, m32, b1p, b2p, lr))


def test_plain_takes_a_learning_rate_per_entry(exact_sqrt):
    """Per-entry learning rates (each tensor's own slot, as the table
    gives the kernel) equal the per-parameter update at each rate, and
    the kernel's sequence emulated at each rate."""
    group = _state(8, SIZES, torch.bfloat16, 9)
    single = _clone(group)
    slots = torch.tensor([1e-3, 1e-4], dtype=torch.float32)
    lrs = [slots[0:1], slots[1:2], slots[0:1]]
    want = [_kernel_emulated(*row, float(lr_), torch.bfloat16)
            for row, lr_ in zip(group, lrs)]
    aw.adamw_multi_plain(*_cols(group), lrs, **HYPER)
    for row, lr_, w in zip(single, lrs, want):
        new = optimizer_ops.adamw(*row, float(lr_), **HYPER)
        assert torch.equal(new[0], w[0])
        for k in (2, 3):
            assert torch.equal(new[k - 1].to(torch.bfloat16), w[k])
    for row, w in zip(group, want):
        for k in (0, 2, 3, 4, 5):
            assert torch.equal(row[k], w[k]), k
    with pytest.raises(ValueError, match="2 learning rates for 3"):
        aw.adamw_multi_plain(*_cols(group), lrs[:2], **HYPER)


@pytest.mark.parametrize("mdtype", [torch.float32, torch.bfloat16])
def test_adam_is_the_kernel_with_zero_coeff(mdtype):
    """Adam rides the AdamW kernel at ``coeff = 0``, where the kernel
    drops the decay term (``p - R(0 * p)`` would turn an infinite
    parameter into NaN): the plain form at coeff 0 (what the kernel
    computes) is the per-parameter ``adam`` exactly, over three steps,
    also for fp16 parameters whose updates overflow."""
    group = _state(9, SIZES + [2 ** 16 + 3], mdtype, 0)
    group[0][0] = torch.tensor([float("inf")])
    single = _clone(group)
    rng = np.random.RandomState(10)
    hyper = dict(HYPER, coeff=0.0)
    for _ in range(3):
        for row, other in zip(group, single):
            g = torch.from_numpy((rng.randn(row[0].numel()) * 1e-2)
                                 .astype(np.float32))
            row[1], other[1] = g, g
        aw.adamw_multi_plain(*_cols(group), 1e-3, **hyper)
        for row in single:
            new = optimizer_ops.adam(*row, 1e-3, 0.9, 0.999, 1e-8)
            row[0], row[4], row[5] = new[0], new[3], new[4]
            row[2], row[3] = new[1].to(mdtype), new[2].to(mdtype)
        for row, other in zip(group, single):
            for k in (0, 2, 3, 4, 5):
                assert _same(row[k], other[k]), k
    assert group[0][0].isinf().all()


def _same(a, b):
    """Equal, NaN where the other is NaN: fp16 with epsilon 1e-8 (below
    fp16's least subnormal) divides by zero where sqrt(m2) underflows, as
    the per-op path does too."""
    na, nb = a.isnan(), b.isnan()
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def _block_walk(sizes, max_tensors):
    """Which elements each block of each launch updates, found as the
    kernel finds them: the last tensor whose first chunk <= the block's
    chunk, within the launch's tensor range."""
    first, chunks, total = aw.chunk_plan(sizes)
    seen = [np.zeros(n, np.int64) for n in sizes]
    steps = np.zeros(len(sizes), np.int64)       # beta-power updates
    ranges = aw.launch_ranges(chunks, max_tensors)
    assert sum(r[3] for r in ranges) == total
    for t0, nt, c0, nchunks in ranges:
        assert c0 == first[t0] and 1 <= nt <= max_tensors
        for b in range(nchunks):
            c = c0 + b
            t = t0 + int(np.searchsorted(first[t0:t0 + nt], c,
                                         side="right")) - 1
            begin = (c - first[t]) * aw.CHUNK
            seen[t][begin:min(sizes[t], begin + aw.CHUNK)] += 1
            steps[t] += 1
    return seen, steps, chunks


@pytest.mark.parametrize("max_tensors", [aw.MAX_TENSORS, 2])
def test_chunk_plan_covers_every_element_once(max_tensors):
    """Sizes 1, 7 and 4097 beside chunk edges and an empty tensor: every
    element is updated by exactly one block, and the number of blocks of
    a tensor is the chunk count its last block waits for (an empty
    tensor gets one, which only advances its beta powers)."""
    sizes = [1, 7, 4097, 0, aw.CHUNK, aw.CHUNK + 1, 2 * aw.CHUNK + 3]
    seen, steps, chunks = _block_walk(sizes, max_tensors)
    for n, s in zip(sizes, seen):
        assert s.shape == (n,) and np.all(s == 1), n
    assert list(steps) == chunks
    assert chunks[3] == 1 and chunks[-1] == 3
    if max_tensors == 2:
        assert len(aw.launch_ranges(chunks, 2)) == 4


def test_optimizer_groups_by_dtype_and_matches_each_parameter(monkeypatch):
    """Mixed float32 and bfloat16 parameters of sizes 1, 7 and 4097 form
    two groups (one launch each on the card); the result equals the
    per-parameter update bit for bit."""
    rng = np.random.RandomState(4)
    params, ref = [], []
    for dt in (torch.float32, torch.bfloat16):
        for n in SIZES:
            a = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dt)
            params.append(torch.nn.Parameter(a))
            ref.append([a.clone(), None, torch.zeros(n, dtype=dt),
                        torch.zeros(n, dtype=dt), torch.ones(1, dtype=dt),
                        torch.ones(1, dtype=dt)])
    calls = []
    real = aw.adamw_multi

    def spy(*args, **kw):
        calls.append([t.dtype for t in args[0]])
        return real(*args, **kw)

    monkeypatch.setattr(aw, "adamw_multi", spy)
    opt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                parameters=[(f"p{i}", p) for i, p in enumerate(params)])
    for step in range(2):
        for p, r in zip(params, ref):
            g = torch.from_numpy(rng.randn(p.numel()).astype(
                np.float32) * 1e-2).to(p.dtype)
            p.grad = g
            r[1] = g
            new = optimizer_ops.adamw(*r, 1e-3, **HYPER)
            r[0], r[4], r[5] = new[0], new[3], new[4]
            r[2], r[3] = new[1].to(p.dtype), new[2].to(p.dtype)
        opt.step()
        for p, r in zip(params, ref):
            assert torch.equal(p.detach(), r[0])
    assert calls == [[torch.float32] * 3, [torch.bfloat16] * 3] * 2


def test_launch_args_match_the_c_entry():
    """The wrapper passes as many arguments, of the same kinds, as the C
    entry in csrc/adamw.cu declares (a mismatch only shows on the
    card), the seventh being the grad scale (a null pointer for none;
    the learning rates live in the table), and the table packs
    ``Entry``'s 72 bytes per tensor, each entry's own lr slot among
    them."""
    src = (pathlib.Path(aw.__file__).resolve().parents[2] / "csrc" /
           "adamw.cu").read_text()
    decl = re.search(r'extern "C" int adamw_multi_launch\(([^)]*)\)', src)
    params = [p.strip() for p in decl.group(1).split(",")]
    kinds = [ctypes.c_void_p if "*" in p else
             ctypes.c_double if p.startswith("double") else ctypes.c_int
             for p in params]
    assert kinds == aw.ARGTYPES
    assert params[6] == "const void* grad_scale"
    assert not any(p.split()[-1] == "lr" for p in params)
    assert "static_assert(sizeof(Entry) == 72" in src
    for name, value in (("kChunk", aw.CHUNK),
                        ("kMaxTensors", aw.MAX_TENSORS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    group = _state(5, SIZES, torch.bfloat16, 0)
    p, g, m1, m2, b1p, b2p = _cols(group)
    lr = torch.tensor([1e-3, 1e-4], dtype=torch.float32)
    lrs = [lr[0:1], lr[1:2], lr[0:1]]
    table = aw.Table(p, m1, m2, b1p, b2p, lrs)
    assert table.tensor.shape == (3, 9) and table.tensor.dtype == torch.int64
    words = table.tensor.numpy()
    assert list(words[:, 0]) == [t.data_ptr() for t in p]
    assert list(words[:, 5]) == [lr.data_ptr(), lr.data_ptr() + 4,
                                 lr.data_ptr()]
    assert list(words[:, 6]) == SIZES
    assert list(words[:, 8] >> 32) == table.chunks
    assert list(words[:, 8] & 0xFFFFFFFF) == [0, 0, 0]
    shared = aw.Table(p, m1, m2, b1p, b2p, lr[1:2]).tensor.numpy()
    assert list(shared[:, 5]) == [lr.data_ptr() + 4] * 3
    with pytest.raises(ValueError, match="float32 \\[1\\]"):
        aw.Table(p, m1, m2, b1p, b2p, lr)
    scal = aw.scalars(0.9, 0.999, 1e-8, 0.01, torch.bfloat16)
    assert scal[:2] == (0.8984375, 1.0)
    for scale in (None, torch.full((1,), 0.5)):
        args = aw.launch_args(table, g, scale, scal, None, 0, 3, 0,
                              sum(table.chunks))
        assert len(args) == len(params)
        for a, kind in zip(args, kinds):
            if kind is ctypes.c_int:
                assert isinstance(a, int)
            elif kind is ctypes.c_double:
                assert isinstance(a, float)
        assert [args[5][i] for i in range(3)] == [t.data_ptr() for t in g]
        assert args[6] == (None if scale is None else scale.data_ptr())


def test_cpu_runs_plain_and_other_devices_raise():
    group = _state(6, [5], torch.float32, 0)
    before = dict(aw.launches)
    aw.adamw_multi(*_cols(group), torch.tensor([1e-3]))
    assert aw.launches == before
    # meta tensors (the abstract interpreter's): an in-place update keeps
    # every shape, and nothing runs
    meta = [[t.to("meta") for t in row] for row in group]
    aw.adamw_multi(*_cols(meta), torch.tensor([1e-3]))
    assert aw.launches == before
    from types import SimpleNamespace
    other = [[SimpleNamespace(device=torch.device("xpu"))] + row[1:]
             for row in group]
    with pytest.raises(ValueError, match="cuda or cpu"):
        aw.adamw_multi(*_cols(other), torch.tensor([1e-3]))


def test_a_cuda_request_without_a_card_raises():
    """With no card (and no nvcc) neither a CUDA tensor nor the kernel's
    library can be had: both raise instead of running something else."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises((RuntimeError, AssertionError)):
        torch.zeros(1, device="cuda")
    if shutil.which("nvcc") is None:
        with pytest.raises(RuntimeError, match="nvcc"):
            aw._lib()
