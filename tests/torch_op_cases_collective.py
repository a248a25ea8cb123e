"""Op cases of the collectives and ``dpsgd`` at one rank
(``torch_op_cases.py``'s form: case id -> (op type, inputs(rng), attrs,
tolerance)), in a module of their own that imports numpy only:
``test_torch_collective_one_rank.py`` holds each against the JAX
package's lowering on the CPU (no mesh axis bound: the reference's
single-trainer branch), and ``chip_smoke.py``'s phase 30 (f) runs each
on the card against the port on the CPU.

``c_embedding:shifted`` takes ids around a ``start_index`` (some below
it, wrapping as ``jnp.take`` wraps, and some past the table, filled with
NaN); ``dpsgd`` draws its noise from the case's key, so JAX runs it
with 64-bit types off (``ONE_RANK_X32``).
"""

import numpy as np


def _f(rng, *shape, pos=False):
    a = rng.randn(*shape).astype(np.float32)
    return np.abs(a) + 0.5 if pos else a


def _bn_ins(r, c=3, shape=(2, 3, 4, 4)):
    return {"X": [_f(r, *shape)], "Scale": [_f(r, c, pos=True)],
            "Bias": [_f(r, c)], "Mean": [_f(r, c)],
            "Variance": [_f(r, c, pos=True)]}


ONE_RANK_CASES = {
    **{op: (op, lambda r: {"X": [_f(r, 3, 4)]}, {"ring_id": 0}, None)
       for op in ("c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
                  "c_allreduce_prod", "c_allreduce_avg", "allreduce",
                  "c_reduce_sum", "c_identity", "c_sync_calc_stream",
                  "c_sync_comm_stream", "partial_allgather")},
    "c_broadcast": ("c_broadcast", lambda r: {"X": [_f(r, 2, 5)]},
                    {"ring_id": 0, "root": 0}, None),
    "c_allgather": ("c_allgather", lambda r: {"X": [_f(r, 4, 3)]},
                    {"ring_id": 0, "nranks": 1}, None),
    "c_concat": ("c_concat", lambda r: {"X": [_f(r, 4, 3)]},
                 {"ring_id": 0, "nranks": 1}, None),
    "c_reducescatter": ("c_reducescatter", lambda r: {"X": [_f(r, 4, 3)]},
                        {"ring_id": 0, "nranks": 1}, None),
    "c_scatter": ("c_scatter", lambda r: {"X": [_f(r, 4, 3)]},
                  {"ring_id": 0, "nranks": 1, "root": 0}, None),
    "c_split": ("c_split", lambda r: {"X": [_f(r, 2, 6)]},
                {"ring_id": 0, "nranks": 1}, None),
    "barrier": ("barrier", lambda r: {"X": [_f(r, 3)]}, {"ring_id": 0},
                None),
    "barrier:empty": ("barrier", lambda r: {}, {"ring_id": 0}, None),
    "c_embedding": ("c_embedding", lambda r: {
        "W": [_f(r, 6, 4)], "Ids": [r.randint(0, 6, (2, 3)).astype(
            np.int64)]}, {"start_index": 0}, None),
    "c_embedding:shifted": ("c_embedding", lambda r: {
        "W": [_f(r, 6, 4)], "Ids": [np.array([[10, 11, 15], [16, 17, 4]],
                                             np.int64)]},
        {"start_index": 10}, None),
    "sync_batch_norm": ("sync_batch_norm", _bn_ins,
                        {"momentum": 0.9, "epsilon": 1e-5}, (1e-5, 1e-4)),
    "sync_batch_norm:is_test": ("sync_batch_norm", _bn_ins,
                                {"is_test": True}, (1e-5, 1e-4)),
    "sync_batch_norm:nhwc": ("sync_batch_norm",
                             lambda r: _bn_ins(r, 3, (2, 4, 4, 3)),
                             {"data_format": "NHWC"}, (1e-5, 1e-4)),
    "dpsgd": ("dpsgd", lambda r: {
        "Param": [_f(r, 5, 3)], "Grad": [_f(r, 5, 3) * 4],
        "LearningRate": [np.array([0.1], np.float32)]},
        {"clip": 1.5, "batch_size": 8.0, "sigma": 0.7}, (1e-5, 1e-5)),
}

#: cases whose JAX lowering runs with 64-bit types off (random streams)
ONE_RANK_X32 = {"dpsgd"}
