"""The GPT-style transformer's programs, built through the fluid layers.

Counterpart of paddle_tpu/models/transformer_program.py:28-80: the same
layer calls, so the same op order, slot names, var names (the fluid
name scopes: `embedding_0.w_0`, `layer_norm_0.w_0`/`.w_1`,
`fc_N.w_0`/`.w_1`, `tmp_N`, ...), shapes, attrs and initializers
(Xavier `uniform_random` with seed 0 for embeddings and fc weights,
`fill_constant` for biases and the layer_norm scale and bias).

- `build_transformer_program` gives the training program's main and
  startup descs (the forward, the `targets` feed and the loss: reshape
  ×2, softmax_with_cross_entropy, mean) with the loss and logits names.
  After `fluid.optimizer.MomentumOptimizer(...).minimize`, both equal
  the JAX package's through `to_dict()`.
- `build_transformer_inference_program` gives the program the JAX
  package exports: the same main program's test clone pruned to the
  logits (`fluid.io.prune_program`).
- `build_transformer_step_program` (the sliding-window decode step) and
  `build_transformer_cached_step_program` (the KV-cached one) give the
  step programs that `fluid.ProgramDecoder` runs, as Programs, equal to
  the JAX package's through `to_dict()`; their parameters carry the
  names of a training program of the same architecture, so a trained
  scope drives them.

The forward: token + position embeddings, `n_layer` pre-norm blocks
(layer_norm, fc to q/k/v, split, flash_attention, fc, residual;
layer_norm, fc + relu, fc, residual), a last layer_norm and the fc to
the vocabulary.  Feeds `tokens` and `positions` are int64 [batch,
seq_len], `targets` int64 [batch, seq_len, 1]; the logits are
`[batch, seq_len, vocab]`.  `sp_axis` records a sequence-parallel axis
in the attention op's attrs; without a device mesh the op runs the
local kernel, as on the JAX side.
"""

import numpy as np

from .. import fluid
from ..fluid.io import prune_program

__all__ = ["build_transformer_program",
           "build_transformer_inference_program",
           "build_transformer_step_program",
           "build_transformer_cached_step_program",
           "init_transformer_params", "transformer_feeds", "logits_name"]


def _block(x, n_head, d_model, d_ff, causal, sp_axis, sp_mode):
    h = fluid.layers.layer_norm(x, begin_norm_axis=2)
    qkv = fluid.layers.fc(input=h, size=3 * d_model, num_flatten_dims=2)
    q, k, v = fluid.layers.split(qkv, num_or_sections=3, dim=-1)
    o = fluid.layers.flash_attention(
        q, k, v, num_heads=n_head, causal=causal,
        sequence_parallel_axis=sp_axis, sequence_parallel_mode=sp_mode)
    x = x + fluid.layers.fc(input=o, size=d_model, num_flatten_dims=2)
    h = fluid.layers.layer_norm(x, begin_norm_axis=2)
    h = fluid.layers.fc(input=h, size=d_ff, num_flatten_dims=2, act="relu")
    return x + fluid.layers.fc(input=h, size=d_model, num_flatten_dims=2)


def _build(batch, seq_len, vocab_size, n_layer, n_head, d_model, d_ff,
           causal, sp_axis, sp_mode):
    """(main, startup, avg_loss, logits): Programs and Variables."""
    if d_ff is None:
        d_ff = 4 * d_model
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        tokens, positions, targets = (
            fluid.layers.data(name=name, shape=shape, dtype="int64",
                              append_batch_size=False)
            for name, shape in (("tokens", [batch, seq_len]),
                                ("positions", [batch, seq_len]),
                                ("targets", [batch, seq_len, 1])))
        x = fluid.layers.embedding(tokens, size=[vocab_size, d_model]) \
            + fluid.layers.embedding(positions, size=[seq_len, d_model])
        for _ in range(n_layer):
            x = _block(x, n_head, d_model, d_ff, causal, sp_axis, sp_mode)
        x = fluid.layers.layer_norm(x, begin_norm_axis=2)
        logits = fluid.layers.fc(input=x, size=vocab_size,
                                 num_flatten_dims=2)
        flat = fluid.layers.reshape(x=logits, shape=[-1, vocab_size])
        flat_tgt = fluid.layers.reshape(x=targets, shape=[-1, 1])
        loss = fluid.layers.softmax_with_cross_entropy(flat, flat_tgt)
        avg_loss = fluid.layers.mean(x=loss)
    return main, startup, avg_loss, logits


def build_transformer_program(batch, seq_len, vocab_size, n_layer=2,
                              n_head=4, d_model=64, d_ff=None, causal=True,
                              sp_axis="", sp_mode="ring"):
    """(main desc, startup desc, loss name, logits name): the training
    program of the JAX package's `build_transformer_program` of the same
    arguments, before its optimizer's `minimize`."""
    main, startup, loss, logits = _build(batch, seq_len, vocab_size,
                                         n_layer, n_head, d_model, d_ff,
                                         causal, sp_axis, sp_mode)
    return main.desc, startup.desc, loss.name, logits.name


def build_transformer_inference_program(batch, seq_len, vocab_size,
                                        n_layer=2, n_head=4, d_model=64,
                                        d_ff=None, causal=True, sp_axis="",
                                        sp_mode="ring"):
    """The inference ProgramDesc: the training program's test clone
    pruned to the logits, as the JAX package exports it."""
    main, _, _, logits = _build(batch, seq_len, vocab_size, n_layer, n_head,
                                d_model, d_ff, causal, sp_axis, sp_mode)
    return prune_program(main, [logits]).desc


def build_transformer_step_program(batch, window, vocab_size, n_layer=2,
                                   n_head=4, d_model=64, d_ff=None,
                                   sp_axis="", sp_mode="ring"):
    """Sliding-window decode step for `fluid.ProgramDecoder`: (main,
    startup, logits, new_window), Programs and Variables.

    Feeds: tok [batch] int32 (the token the decoder just chose), window
    [batch, window] int64 (the last `window` tokens), positions
    [batch, window].  Fetches: logits [batch, vocab] for the NEXT token
    and the shifted window; wire it as::

        dec = fluid.ProgramDecoder(
            prog.clone(for_test=True), token_name="tok",
            logits_name=logits.name,
            state_pairs=[("window", new_window.name),
                         ("positions", "positions")])

    Each step is a full causal forward over the window: the flash kernel
    runs once per layer.  Exact for contexts up to `window`.
    """
    if d_ff is None:
        d_ff = 4 * d_model
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        tok = fluid.layers.data(name="tok", shape=[batch], dtype="int32",
                                append_batch_size=False)
        win = fluid.layers.data(name="window", shape=[batch, window],
                                dtype="int64", append_batch_size=False)
        positions = fluid.layers.data(
            name="positions", shape=[batch, window], dtype="int64",
            append_batch_size=False)
        tok64 = fluid.layers.reshape(
            x=fluid.layers.cast(tok, "int64"), shape=[batch, 1])
        _, rest = fluid.layers.split(win, num_or_sections=[1, window - 1],
                                     dim=1)
        new_window = fluid.layers.concat([rest, tok64], axis=1)
        x = fluid.layers.embedding(new_window,
                                   size=[vocab_size, d_model]) \
            + fluid.layers.embedding(positions, size=[window, d_model])
        for _ in range(n_layer):
            x = _block(x, n_head, d_model, d_ff, True, sp_axis, sp_mode)
        x = fluid.layers.layer_norm(x, begin_norm_axis=2)
        logits3 = fluid.layers.fc(input=x, size=vocab_size,
                                  num_flatten_dims=2)
        _, last = fluid.layers.split(
            logits3, num_or_sections=[window - 1, 1], dim=1)
        logits = fluid.layers.reshape(x=last, shape=[batch, vocab_size])
    return main, startup, logits, new_window


def build_transformer_cached_step_program(batch, max_len, vocab_size,
                                          n_layer=2, n_head=4,
                                          d_model=64, d_ff=None):
    """KV-cached decode step: O(1) attention work per generated token.
    Returns (main, startup, logits, state_pairs), where state_pairs
    wires straight into `fluid.ProgramDecoder` (pass
    max_positions=max_len so decoding past the cache extent raises).

    Feeds: tok [batch] int32, pos [batch] int64 (the slot being
    written; per row so beam expansion can repeat it, rows advancing in
    lockstep), per-layer caches k_cache_i/v_cache_i [batch, n_head,
    max_len, d_head] f32.  Fetches: logits [batch, vocab], pos + 1 and
    the updated caches.  max_len must not exceed the trained sequence
    length (the position embedding's rows).
    """
    if d_ff is None:
        d_ff = 4 * d_model
    d_head = d_model // n_head
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        tok = fluid.layers.data(name="tok", shape=[batch], dtype="int32",
                                append_batch_size=False)
        pos = fluid.layers.data(name="pos", shape=[-1], dtype="int64",
                                append_batch_size=False)
        caches = [tuple(
            fluid.layers.data(name="%s_cache_%d" % (kv, i),
                              shape=[batch, n_head, max_len, d_head],
                              dtype="float32", append_batch_size=False)
            for kv in "kv") for i in range(n_layer)]
        # lookup_table squeezes a trailing size-1 ids dim, so
        # [batch, 1, 1] ids yield [batch, 1, d]
        tok64 = fluid.layers.reshape(
            x=fluid.layers.cast(tok, "int64"), shape=[batch, 1, 1])
        # rows move in lockstep: one position row serves the whole batch,
        # and the residual add broadcasts its [1, 1, d] over the batch
        pos_ids = fluid.layers.reshape(x=fluid.layers.reduce_max(pos),
                                       shape=[1, 1, 1])
        x = fluid.layers.embedding(tok64, size=[vocab_size, d_model]) \
            + fluid.layers.embedding(pos_ids, size=[max_len, d_model])
        state_pairs = []
        for i in range(n_layer):
            h = fluid.layers.layer_norm(x, begin_norm_axis=2)
            qkv = fluid.layers.fc(input=h, size=3 * d_model,
                                  num_flatten_dims=2)
            q, k, v = fluid.layers.split(qkv, num_or_sections=3, dim=-1)
            o, kc_out, vc_out = fluid.layers.cached_attention(
                q, k, v, caches[i][0], caches[i][1], pos, num_heads=n_head)
            state_pairs += [("k_cache_%d" % i, kc_out.name),
                            ("v_cache_%d" % i, vc_out.name)]
            x = x + fluid.layers.fc(input=o, size=d_model,
                                    num_flatten_dims=2)
            h = fluid.layers.layer_norm(x, begin_norm_axis=2)
            h = fluid.layers.fc(input=h, size=d_ff, num_flatten_dims=2,
                                act="relu")
            x = x + fluid.layers.fc(input=h, size=d_model,
                                    num_flatten_dims=2)
        x = fluid.layers.layer_norm(x, begin_norm_axis=2)
        logits3 = fluid.layers.fc(input=x, size=vocab_size,
                                  num_flatten_dims=2)
        logits = fluid.layers.reshape(x=logits3, shape=[batch, vocab_size])
        pos_out = fluid.layers.increment(pos, value=1, in_place=False)
        state_pairs.append(("pos", pos_out.name))
    return main, startup, logits, state_pairs


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
