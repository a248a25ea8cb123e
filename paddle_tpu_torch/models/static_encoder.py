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


def build_encoder_program(num_layers: int = 6, d_model: int = 512,
                          num_heads: int = 8, d_ffn: int = 2048,
                          seq: int = 1024, lr: float = 1e-4,
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
        st.AdamW(learning_rate=lr, weight_decay=weight_decay).minimize(loss)
    return main, startup, loss
