"""A Transformer encoder written as tape ``Layer``s: the counterpart on
the dygraph tape of :mod:`.static_encoder`'s Program, op for op.

Per layer: Q, K and V as ``matmul_v2`` and ``elementwise_add`` (the
static ``fc``'s ``mul`` and bias), ``reshape2`` to heads and
``transpose2`` to ``[b, h, s, d]``; ``fused_attention_qkv``
(non-causal, no mask); back to ``[b, s, d_model]``, an output
projection, a residual ``elementwise_add`` and ``layer_norm`` (Scale and
Bias, ``begin_norm_axis`` 2); the FFN (projection, ``relu``,
projection), a residual and ``layer_norm``. :func:`encoder_loss` is the
``reduce_mean`` of the squared output. Every op runs through the tape's
``run_op``, so under ``FLAGS_use_pallas_attention`` (sequence at least
``FLAGS_pallas_min_seq``) and ``FLAGS_use_pallas_layer_norm`` the
attention and LayerNorm take the flash and LayerNorm kernels, forward
and backward.

The parameters carry the static program's names (``fc_<6 i + j>.w_0``
and ``.w_1`` for the weights and biases of q, k, v, out, FFN in and FFN
out; ``layer_norm_<2 i + j>.w_0`` / ``.w_1``), so a scope of
:func:`~.static_encoder.build_encoder_program` copies in by name
(:func:`load_scope`). ``dygraph`` is the package's dygraph module the
layers are built with: the port's by default; a test passes the JAX
package's to build the same encoder there, seeded alike.
"""

from __future__ import annotations


def _port_dygraph():
    from .. import dygraph
    return dygraph


def build_tape_encoder(num_layers: int = 6, d_model: int = 512,
                       num_heads: int = 8, d_ffn: int = 2048, *,
                       dygraph=None, device=None):
    """The encoder Layer (call it on ``x [batch, seq, d_model]``) over
    ``dygraph``'s ``Layer`` and ``run_op``, its parameters on ``device``
    (None: the card) when the package is the port's."""
    dy = dygraph or _port_dygraph()
    run_op = dy.run_op
    dh = d_model // num_heads
    kw = {"device": device} if dygraph is None else {}

    def op(t, ins, attrs, slot="Out"):
        return run_op(t, ins, attrs)[slot][0]

    class EncoderLayer(dy.Layer):
        def __init__(self, i):
            super().__init__(**kw)
            self.fc = []
            for j, (fi, fo) in enumerate(((d_model, d_model),) * 4 + (
                    (d_model, d_ffn), (d_ffn, d_model))):
                n = f"fc_{6 * i + j}"
                w = self.create_parameter([fi, fo], attr=f"{n}.w_0")
                b = self.create_parameter([fo], attr=f"{n}.w_1",
                                          is_bias=True)
                setattr(self, f"w{j}", w)
                setattr(self, f"b{j}", b)
                self.fc.append((w, b))
            self.ln = []
            for j in range(2):
                n = f"layer_norm_{2 * i + j}"
                g = self.create_parameter(
                    [d_model], attr=f"{n}.w_0",
                    default_initializer=dy.layers.ConstantInitializer(1.0))
                b = self.create_parameter([d_model], attr=f"{n}.w_1",
                                          is_bias=True)
                setattr(self, f"g{j}", g)
                setattr(self, f"beta{j}", b)
                self.ln.append((g, b))

        def linear(self, x, j):
            w, b = self.fc[j]
            return op("elementwise_add", {"X": [op("matmul_v2", {
                "X": [x], "Y": [w]}, {})], "Y": [b]}, {"axis": -1})

        def norm(self, x, j):
            g, b = self.ln[j]
            return op("layer_norm", {"X": [x], "Scale": [g], "Bias": [b]},
                      {"epsilon": 1e-5, "begin_norm_axis": 2}, "Y")

        def forward(self, x):
            def heads(t):
                t = op("reshape2", {"X": [t]},
                       {"shape": [0, 0, num_heads, dh]})
                return op("transpose2", {"X": [t]}, {"axis": [0, 2, 1, 3]})

            q, k, v = (heads(self.linear(x, j)) for j in range(3))
            att = op("fused_attention_qkv", {"Q": [q], "K": [k], "V": [v]},
                     {"causal": False})
            att = op("transpose2", {"X": [att]}, {"axis": [0, 2, 1, 3]})
            att = op("reshape2", {"X": [att]}, {"shape": [0, 0, d_model]})
            x = self.norm(op("elementwise_add", {
                "X": [x], "Y": [self.linear(att, 3)]}, {}), 0)
            f = op("relu", {"X": [self.linear(x, 4)]}, {})
            return self.norm(op("elementwise_add", {
                "X": [x], "Y": [self.linear(f, 5)]}, {}), 1)

    class Encoder(dy.Layer):
        def __init__(self):
            super().__init__(**kw)
            self.layers = dy.LayerList([EncoderLayer(i)
                                        for i in range(num_layers)])

        def forward(self, x):
            for layer in self.layers:
                x = layer(x)
            return x

    return Encoder()


def encoder_loss(dygraph, out):
    """The static program's loss: ``reduce_mean(square(out))``."""
    sq = dygraph.run_op("square", {"X": [out]}, {})["Out"][0]
    return dygraph.run_op("reduce_mean", {"X": [sq]},
                          {"reduce_all": True})["Out"][0]


def load_scope(encoder, scope):
    """Copy a static encoder scope's parameters into ``encoder``'s
    Parameters by name (in place, on their device)."""
    for p in encoder.parameters():
        p.set_value(scope.find_var(p.name))
