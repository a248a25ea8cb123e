"""1:1 fluid.layers veneers over existing lowerings — the counterpart of
``paddle_tpu/layers/nn_veneer.py`` for the three whose lowerings the
port has and :class:`~.dynamic_rnn.DynamicRNN` unrolls with:
``slice``, ``squeeze`` and ``stack``, copies of the reference's. The
rest of the file (~100 veneers) waits for ROADMAP A7.2b, with the
lowerings behind them.
"""

from __future__ import annotations

from .nn_extra import _one_out


def slice(input, axes, starts, ends, name=None):  # noqa: A002
    return _one_out("slice", {"X": input},
                    {"axes": list(axes), "starts": list(starts),
                     "ends": list(ends)}, name=name)


def squeeze(input, axes, name=None):  # noqa: A002
    return _one_out("squeeze", {"X": input}, {"axes": list(axes)},
                    name=name)


def stack(x, axis=0, name=None):
    return _one_out("stack", {"X": list(x)}, {"axis": int(axis)},
                    out_slot="Y", name=name)
