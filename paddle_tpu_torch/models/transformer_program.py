"""The GPT-style transformer's programs, built as ProgramDescs.

Counterpart of paddle_tpu/models/transformer_program.py.  The JAX
package builds the program through its fluid layers; the port has no
layer builder yet (ROADMAP A3), so this module writes the same descs
directly: the same op order, slot names, var names (the fluid name
scopes: `embedding_0.w_0`, `layer_norm_0.w_0`/`.w_1`, `fc_N.w_0`/`.w_1`,
`tmp_N`, ...), shapes and attrs.

- `build_transformer_program` gives the training program's main desc
  (the forward, the `targets` feed and the loss: reshape ×2,
  softmax_with_cross_entropy, mean) and its startup desc (the JAX
  initializers: Xavier `uniform_random` with seed 0 for embeddings and
  fc weights, `fill_constant` for biases and the layer_norm scale and
  bias).  After `fluid.optimizer.MomentumOptimizer(...).minimize`, both
  equal the JAX package's through `to_dict()`.
- `build_transformer_inference_program` gives the program the JAX
  package exports (pruned to the logits), equal to it through
  `to_dict()`.

The forward: token + position embeddings, `n_layer` pre-norm blocks
(layer_norm, fc to q/k/v, split, causal flash_attention, fc, residual;
layer_norm, fc + relu, fc, residual), a last layer_norm and the fc to
the vocabulary.  Feeds `tokens` and `positions` are int64 [batch,
seq_len], `targets` int64 [batch, seq_len, 1]; the logits are
`[batch, seq_len, vocab]`.
"""

import math

import numpy as np

from ..core.desc import OpDesc, ProgramDesc, VarDesc
from ..core.types import exec_dtype

__all__ = ["build_transformer_program",
           "build_transformer_inference_program", "init_transformer_params",
           "transformer_feeds", "logits_name"]


class _Builder:
    """Appends vars and ops to block 0 with fluid's unique names; with
    `startup`, also declares each parameter in a startup desc and
    appends its initializer there."""

    def __init__(self, startup=False):
        self.desc = ProgramDesc()
        self.block = self.desc.block(0)
        self.startup = ProgramDesc() if startup else None
        self._ids = {}

    def uniq(self, prefix):
        n = self._ids.get(prefix, 0)
        self._ids[prefix] = n + 1
        return "%s_%d" % (prefix, n)

    def var(self, name, shape, dtype="float32", param=False,
            stop_gradient=False):
        v = VarDesc(name, dtype=dtype, shape=shape, persistable=param,
                    stop_gradient=stop_gradient, is_parameter=param)
        self.block.vars[name] = v
        return v

    def param(self, name, shape, fill=None):
        """A parameter, initialised Xavier-uniform (fill None) or to the
        constant `fill`."""
        v = self.var(name, shape, param=True)
        if self.startup is not None:
            sb = self.startup.block(0)
            sb.vars[name] = VarDesc(name, shape=shape, persistable=True)
            if fill is None:
                limit = math.sqrt(6.0 / (shape[0] + shape[1]))
                sb.ops.append(OpDesc(
                    "uniform_random", {}, {"Out": [name]},
                    {"shape": list(shape), "dtype": "float32",
                     "min": -limit, "max": limit, "seed": 0}))
            else:
                sb.ops.append(OpDesc(
                    "fill_constant", {}, {"Out": [name]},
                    {"shape": list(shape), "dtype": "float32",
                     "value": fill}))
        return v

    def op(self, type, inputs, outputs, attrs):
        self.block.ops.append(OpDesc(
            type, {k: [v.name for v in vs] for k, vs in inputs.items()},
            {k: [v.name for v in vs] for k, vs in outputs.items()}, attrs))

    # -- the fluid layers the transformer uses -----------------------------
    def data(self, name, shape):
        return self.var(name, shape, dtype="int64", stop_gradient=True)

    def embedding(self, ids, size):
        h = self.uniq("embedding")
        w = self.param(h + ".w_0", size)
        out = self.var(h + ".tmp_0", ids.shape + (size[1],))
        self.op("lookup_table", {"Ids": [ids], "W": [w]}, {"Out": [out]},
                {"is_sparse": False, "padding_idx": -1})
        return out

    def add(self, x, y):
        out = self.var(self.uniq("tmp"), x.shape)
        self.op("elementwise_add", {"X": [x], "Y": [y]}, {"Out": [out]},
                {"axis": -1})
        return out

    def layer_norm(self, x):
        h = self.uniq("layer_norm")
        lead = int(np.prod(x.shape[:2]))
        scale = self.param(h + ".w_0", x.shape[2:], 1.0)
        bias = self.param(h + ".w_1", x.shape[2:], 0.0)
        y = self.var(h + ".tmp_0", x.shape)
        mean = self.var(h + ".tmp_1", (lead,), stop_gradient=True)
        var = self.var(h + ".tmp_2", (lead,), stop_gradient=True)
        self.op("layer_norm", {"X": [x], "Scale": [scale], "Bias": [bias]},
                {"Y": [y], "Mean": [mean], "Variance": [var]},
                {"epsilon": 1e-05, "begin_norm_axis": 2})
        return y

    def fc(self, x, size, act=None):
        h = self.uniq("fc")
        w = self.param(h + ".w_0", (x.shape[2], size))
        mul_out = self.var(h + ".tmp_0", x.shape[:2] + (size,))
        self.op("mul", {"X": [x], "Y": [w]}, {"Out": [mul_out]},
                {"x_num_col_dims": 2, "y_num_col_dims": 1})
        b = self.param(h + ".w_1", (size,), 0.0)
        out = self.var(h + ".tmp_1", mul_out.shape)
        self.op("elementwise_add", {"X": [mul_out], "Y": [b]},
                {"Out": [out]}, {"axis": 2})
        if act == "relu":
            act_out = self.var(h + ".tmp_2", out.shape)
            self.op("relu", {"X": [out]}, {"Out": [act_out]}, {})
            out = act_out
        return out

    def split3(self, x):
        h = self.uniq("split")
        shape = x.shape[:2] + (x.shape[2] // 3,)
        outs = [self.var("%s.tmp_%d" % (h, i), shape) for i in range(3)]
        self.op("split", {"X": [x]}, {"Out": outs},
                {"axis": 2, "sections": [], "num": 3})
        return outs

    def flash_attention(self, q, k, v, num_heads, causal):
        h = self.uniq("flash_attention")
        out = self.var(h + ".tmp_0", q.shape)
        self.op("flash_attention", {"Q": [q], "K": [k], "V": [v]},
                {"Out": [out]},
                {"num_heads": num_heads, "causal": causal, "sm_scale": 0.0,
                 "sequence_parallel_axis": "",
                 "sequence_parallel_mode": "ring", "block_size": 128})
        return out


    def reshape(self, x, shape):
        """reference reshape_op.cc: a 0 copies the input dim, one -1 is
        inferred; the output has x's execution dtype (int64 targets
        reshape to int32, as the JAX side's shape inference records)."""
        h = self.uniq("reshape")
        dims = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
        known = int(np.prod([d for d in dims if d != -1]))
        dims = [int(np.prod(x.shape)) // known if d == -1 else d
                for d in dims]
        out = self.var(h + ".tmp_0", tuple(dims), dtype=exec_dtype(x.dtype))
        self.op("reshape", {"X": [x]}, {"Out": [out]},
                {"shape": list(shape)})
        return out

    def softmax_with_cross_entropy(self, logits, label):
        h = self.uniq("softmax_with_cross_entropy")
        softmax = self.var(h + ".tmp_0", logits.shape)
        loss = self.var(h + ".tmp_1", logits.shape[:-1] + (1,))
        self.op("softmax_with_cross_entropy",
                {"Logits": [logits], "Label": [label]},
                {"Softmax": [softmax], "Loss": [loss]},
                {"soft_label": False})
        return loss

    def mean(self, x):
        out = self.var(self.uniq("mean") + ".tmp_0", (1,))
        self.op("mean", {"X": [x]}, {"Out": [out]}, {})
        return out


def _forward(b, batch, seq_len, vocab_size, n_layer, n_head, d_model, d_ff,
             causal, train):
    """The forward into builder `b`; returns the logits var and, for
    `train`, the targets feed var (else None)."""
    if d_ff is None:
        d_ff = 4 * d_model
    tokens = b.data("tokens", (batch, seq_len))
    positions = b.data("positions", (batch, seq_len))
    targets = b.data("targets", (batch, seq_len, 1)) if train else None
    x = b.add(b.embedding(tokens, (vocab_size, d_model)),
              b.embedding(positions, (seq_len, d_model)))
    for _ in range(n_layer):
        h = b.layer_norm(x)
        q, k, v = b.split3(b.fc(h, 3 * d_model))
        o = b.flash_attention(q, k, v, n_head, causal)
        x = b.add(x, b.fc(o, d_model))
        h = b.fc(b.layer_norm(x), d_ff, act="relu")
        x = b.add(x, b.fc(h, d_model))
    return b.fc(b.layer_norm(x), vocab_size), targets


def build_transformer_program(batch, seq_len, vocab_size, n_layer=2,
                              n_head=4, d_model=64, d_ff=None, causal=True):
    """(main, startup, loss name, logits name): the training program of
    the JAX package's `build_transformer_program` of the same
    arguments, before its optimizer's `minimize`."""
    b = _Builder(startup=True)
    logits, targets = _forward(b, batch, seq_len, vocab_size, n_layer,
                               n_head, d_model, d_ff, causal, True)
    flat = b.reshape(logits, [-1, vocab_size])
    flat_tgt = b.reshape(targets, [-1, 1])
    avg_loss = b.mean(b.softmax_with_cross_entropy(flat, flat_tgt))
    return b.desc, b.startup, avg_loss.name, logits.name


def build_transformer_inference_program(batch, seq_len, vocab_size,
                                        n_layer=2, n_head=4, d_model=64,
                                        d_ff=None, causal=True):
    """The pruned inference ProgramDesc of the JAX package's
    `build_transformer_program` of the same arguments."""
    b = _Builder()
    _forward(b, batch, seq_len, vocab_size, n_layer, n_head, d_model, d_ff,
             causal, False)
    return b.desc


def logits_name(n_layer):
    """The logits var of an `n_layer` program (its last fc's output)."""
    return "fc_%d.tmp_1" % (4 * n_layer)


def init_transformer_params(program, seed=0):
    """{name: float32 ndarray} for every parameter of `program`, drawn
    with numpy from `seed` with the JAX startup's distributions: Xavier
    uniform for embeddings and fc weights, zeros for biases, ones and
    zeros for layer_norm scale and bias.  The values differ from the JAX
    package's (its PRNG is not numpy's)."""
    rs = np.random.RandomState(seed)
    block = program.block(0)
    params = {}

    def draw(name, fill=None):
        if name in params:
            return
        shape = block.var(name).shape
        if fill is not None:
            params[name] = np.full(shape, fill, np.float32)
        else:
            limit = np.sqrt(6.0 / (shape[0] + shape[1]))
            params[name] = rs.uniform(-limit, limit, shape) \
                .astype(np.float32)

    for op in block.ops:
        if op.type == "lookup_table":
            draw(op.input("W")[0])
        elif op.type == "mul":
            draw(op.input("Y")[0])
        elif op.type == "layer_norm":
            draw(op.input("Scale")[0], 1.0)
            draw(op.input("Bias")[0], 0.0)
        elif op.type == "elementwise_add":
            y = op.input("Y")[0]
            if block.var(y).persistable:
                draw(y, 0.0)
    return params


def transformer_feeds(batch, seq_len, vocab_size, seed=0, targets=False):
    """Random `tokens` and the `positions` 0..seq_len-1, int64
    [batch, seq_len]; with `targets`, also random int64 `targets`
    [batch, seq_len, 1] (the JAX side's `transformer_program_feeds` of
    the same seed, in the same order)."""
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, vocab_size, size=(batch, seq_len))
    positions = np.broadcast_to(np.arange(seq_len), (batch, seq_len))
    feeds = {"tokens": tokens.astype(np.int64),
             "positions": np.ascontiguousarray(positions).astype(np.int64)}
    if targets:
        feeds["targets"] = rs.randint(0, vocab_size,
                                      size=(batch, seq_len, 1)) \
            .astype(np.int64)
    return feeds
