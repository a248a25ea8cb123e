"""A Transformer encoder built as a static Program with the ``layers``
builders: the program ``chip_smoke.py`` trains through the executor on
the card (Transformer-base's encoder widths), and the one the CPU tests
build with both packages.

Per layer: Q, K and V from ``fc`` (``num_flatten_dims=2``), ``reshape``
to heads and ``transpose`` to ``[b, h, s, d]``; an appended
``fused_attention_qkv`` op (non-causal, no mask), as
``paddle_tpu/models/ctr.py`` appends its op; back to ``[b, s, d_model]``,
an output ``fc``, a residual ``elementwise_add`` and ``layer_norm``; the
FFN (``fc`` relu, ``fc``), a residual and ``layer_norm``. The loss is the
``reduce_mean`` of the squared output, minimized by ``AdamW``. Under
``FLAGS_use_pallas_attention`` (sequence at least
``FLAGS_pallas_min_seq``) and ``FLAGS_use_pallas_layer_norm`` the ops
take the flash and LayerNorm kernels, forward and (through the generic
grad) backward.

The learning rate is a float, or a schedule built into the Program
(:class:`NoamLR`: Transformer-base's warm-up, ``step < W`` under
``layers.case``, from ``autoincreased_step_counter``; :class:`FedLR`: a
``[1]`` variable fed each run).

:func:`build_loop_program` is one layer of the same widths, its weights
shared across iterations, under ``while_loop`` (a fed trip count ``n``;
``max_iters`` makes it trainable), and :func:`build_unrolled_program`
its straight-line twin of a given depth over the same weights: the
programs of ``chip_smoke.py``'s phase 25 and of
``tests/test_torch_control_flow.py``.
"""

from __future__ import annotations

from types import SimpleNamespace


def port_static():
    """The port's static-graph modules, as :func:`build_encoder_program`
    takes them."""
    from .. import layers, optimizer
    from ..framework import Program, program_guard, unique_name
    return SimpleNamespace(layers=layers, Program=Program,
                           program_guard=program_guard,
                           unique_name=unique_name, AdamW=optimizer.AdamW)


class NoamLR:
    """Transformer-base's learning rate (Vaswani et al., 2017, 5.3):
    ``scale * d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)``,
    built in the Program from a step counter (1 at the first run) and
    ``layers.case``: the linear warm-up while ``step < warmup``, the
    inverse square root after. ``var`` is the lr variable once built."""

    def __init__(self, warmup: int, scale: float = 1.0):
        self.warmup, self.scale = int(warmup), float(scale)
        self.var = None

    def factors(self, d_model):
        """The warm-up's and the decay's constant factors."""
        base = self.scale * float(d_model) ** -0.5
        return base * self.warmup ** -1.5, base

    def __call__(self, L, d_model):
        step = L.autoincreased_step_counter(counter_name="@LR_STEP@",
                                            begin=1)
        s = L.cast(step, "float32")
        w = L.fill_constant([1], "int64", self.warmup)
        warm, decay = self.factors(d_model)
        self.var = L.case(
            [(L.less_than(step, w), lambda: L.scale(s, scale=warm))],
            default=lambda: L.scale(L.pow(s, -0.5), scale=decay))
        return self.var

    def closed_form(self, step: int, d_model: int) -> float:
        """The schedule's value at ``step`` in float32 arithmetic, the
        ops' order."""
        import numpy as np
        f = np.float32
        warm, decay = self.factors(d_model)
        if step < self.warmup:
            return float(f(step) * f(warm))
        return float(np.power(f(step), f(-0.5)) * f(decay))


class FedLR:
    """A ``[1]`` float32 learning rate fed as ``lr`` each run."""

    def __init__(self):
        self.var = None

    def __call__(self, L, d_model):
        self.var = L.data("lr", [1], append_batch_size=False)
        return self.var


def build_encoder_program(num_layers: int = 6, d_model: int = 512,
                          num_heads: int = 8, d_ffn: int = 2048,
                          seq: int = 1024, lr=1e-4,
                          weight_decay: float = 0.01, seed: int = 0, *,
                          static=None):
    """``(main, startup, loss)``; feed ``x`` ``[batch, seq, d_model]``
    float32. ``static`` holds the modules to build with (``layers``,
    ``Program``, ``program_guard``, ``unique_name``, ``AdamW``): the
    port's by default (:func:`port_static`); a test passes the JAX
    package's to build the same program there. Both programs carry
    ``random_seed = seed``, so their startup runs draw the same
    weights."""
    st = static or port_static()
    L = st.layers
    dh = d_model // num_heads
    main, startup = st.Program(), st.Program()
    main.random_seed = startup.random_seed = seed
    with st.program_guard(main, startup), st.unique_name.guard():
        blk = main.global_block()
        x = L.data("x", [seq, d_model])

        def heads(t):
            t = L.reshape(t, [0, 0, num_heads, dh])
            return L.transpose(t, [0, 2, 1, 3])

        for i in range(num_layers):
            q, k, v = (heads(L.fc(x, d_model, num_flatten_dims=2))
                       for _ in range(3))
            att = blk.create_var(f"attn_{i}", shape=[-1, num_heads, seq, dh])
            blk.append_op("fused_attention_qkv",
                          {"Q": [q.name], "K": [k.name], "V": [v.name]},
                          {"Out": [att.name]}, {"causal": False})
            att = L.reshape(L.transpose(att, [0, 2, 1, 3]), [0, 0, d_model])
            o = L.fc(att, d_model, num_flatten_dims=2)
            x = L.layer_norm(L.elementwise_add(x, o), begin_norm_axis=2)
            f = L.fc(x, d_ffn, num_flatten_dims=2, act="relu")
            f = L.fc(f, d_model, num_flatten_dims=2)
            x = L.layer_norm(L.elementwise_add(x, f), begin_norm_axis=2)
        loss = L.reduce_mean(L.square(x))
        rate = lr(L, d_model) if callable(lr) else lr
        st.AdamW(learning_rate=rate, weight_decay=weight_decay).minimize(loss)
    return main, startup, loss


def _shared_params(L, d_model, d_ffn):
    """One encoder layer's weights, named, in the global block: the
    loop's body and the unrolled twin read the same ones."""
    out = {}
    for n, shape in (("q", [d_model, d_model]), ("k", [d_model, d_model]),
                     ("v", [d_model, d_model]), ("o", [d_model, d_model]),
                     ("f1", [d_model, d_ffn]), ("f2", [d_ffn, d_model])):
        out[n + ".w"] = L.create_parameter(shape, "float32",
                                           name=f"shared_{n}.w")
        out[n + ".b"] = L.create_parameter([shape[1]], "float32",
                                           name=f"shared_{n}.b",
                                           is_bias=True)
    for n in ("ln1", "ln2"):
        out[n + ".g"] = L.create_parameter([d_model], "float32",
                                           name=f"shared_{n}.g")
        out[n + ".b"] = L.create_parameter([d_model], "float32",
                                           name=f"shared_{n}.b",
                                           is_bias=True)
    return out


def _shared_layer(L, blk, x, P, num_heads, seq, d_model, tag):
    """One encoder layer over the weights ``P`` (matmuls, the appended
    attention op, LayerNorm ops with Scale and Bias)."""
    dh = d_model // num_heads

    def lin(t, n, act=None):
        y = L.elementwise_add(L.matmul(t, P[n + ".w"]), P[n + ".b"])
        return L.relu(y) if act == "relu" else y

    def heads(t):
        return L.transpose(L.reshape(t, [0, 0, num_heads, dh]), [0, 2, 1, 3])

    def norm(t, n):
        y = blk.create_var(f"{tag}_{n}_y")
        m = blk.create_var(f"{tag}_{n}_m")
        v = blk.create_var(f"{tag}_{n}_v")
        blk.append_op("layer_norm", {"X": [t.name], "Scale": [P[n + ".g"].name],
                                     "Bias": [P[n + ".b"].name]},
                      {"Y": [y.name], "Mean": [m.name], "Variance": [v.name]},
                      {"epsilon": 1e-5, "begin_norm_axis": 2})
        return y

    q, k, v = heads(lin(x, "q")), heads(lin(x, "k")), heads(lin(x, "v"))
    att = blk.create_var(f"{tag}_attn", shape=[-1, num_heads, seq, dh])
    blk.append_op("fused_attention_qkv",
                  {"Q": [q.name], "K": [k.name], "V": [v.name]},
                  {"Out": [att.name]}, {"causal": False})
    att = L.reshape(L.transpose(att, [0, 2, 1, 3]), [0, 0, d_model])
    x = norm(L.elementwise_add(x, lin(att, "o")), "ln1")
    f = lin(lin(x, "f1", act="relu"), "f2")
    return norm(L.elementwise_add(x, f), "ln2")


def build_loop_program(d_model: int = 512, num_heads: int = 8,
                       d_ffn: int = 2048, seq: int = 1024, *,
                       max_iters=None, lr: float = 1e-4,
                       weight_decay: float = 0.01, seed: int = 0,
                       static=None):
    """``(main, startup, out, loss)``: one encoder layer applied while
    ``i < n`` (feeds ``x`` ``[batch, seq, d_model]`` float32 and ``n``
    ``[1]`` int64), its weights shared across iterations. With
    ``max_iters`` the loop is differentiable and AdamW minimizes the
    mean square of the output; without, the program is forward only."""
    st = static or port_static()
    L = st.layers
    main, startup = st.Program(), st.Program()
    main.random_seed = startup.random_seed = seed
    with st.program_guard(main, startup), st.unique_name.guard():
        blk = main.global_block()
        x = L.data("x", [seq, d_model])
        n = L.data("n", [1], dtype="int64", append_batch_size=False)
        P = _shared_params(L, d_model, d_ffn)
        i = L.fill_constant([1], "int64", 0)

        def body(i, h):
            cur = main.current_block()
            return (L.increment(i, 1.0),
                    _shared_layer(L, cur, h, P, num_heads, seq, d_model,
                                  "loop"))

        _, out = L.while_loop(lambda i, h: L.less_than(i, n), body, [i, x],
                              max_iters=max_iters)
        loss = L.reduce_mean(L.square(out))
        if max_iters is not None:
            st.AdamW(learning_rate=lr,
                     weight_decay=weight_decay).minimize(loss)
    return main, startup, out, loss


def build_unrolled_program(depth: int, d_model: int = 512,
                           num_heads: int = 8, d_ffn: int = 2048,
                           seq: int = 1024, *, train: bool = False,
                           lr: float = 1e-4, weight_decay: float = 0.01,
                           seed: int = 0, static=None):
    """:func:`build_loop_program`'s straight-line twin: ``depth`` layers
    over the same named weights, feed ``x`` only."""
    st = static or port_static()
    L = st.layers
    main, startup = st.Program(), st.Program()
    main.random_seed = startup.random_seed = seed
    with st.program_guard(main, startup), st.unique_name.guard():
        blk = main.global_block()
        h = L.data("x", [seq, d_model])
        P = _shared_params(L, d_model, d_ffn)
        for j in range(depth):
            h = _shared_layer(L, blk, h, P, num_heads, seq, d_model,
                              f"layer{j}")
        loss = L.reduce_mean(L.square(h))
        if train:
            st.AdamW(learning_rate=lr,
                     weight_decay=weight_decay).minimize(loss)
    return main, startup, h, loss
