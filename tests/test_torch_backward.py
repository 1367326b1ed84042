"""The port's backward and optimizer (paddle_tpu_torch.fluid.backward /
optimizer) against the JAX package's fluid.

- The transformer's training program built by the port
  (`build_transformer_program`, then `MomentumOptimizer.minimize` in its
  desc form, `minimize(loss_name, main_desc, startup_desc)`) equals the JAX package's through `to_dict()`, main and startup, at the
  test size (batch 4, seq 32, vocab 64, 2 layers, 4 heads, d_model 32)
  and at `bench.py`'s full width (descs only).
- For forward programs the JAX layers build, the port's
  `append_backward` on the loss of the parsed forward desc (wrapped by
  `Program.from_desc`) gives the desc the JAX
  backward gives: grad accumulation with `sum` and the `@RENAME@0r`
  rename, a parameter used twice, a sparse embedding's SelectedRows
  grad, `no_grad_set` and `parameter_list`.

All comparisons are exact (descs are data).
"""

import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid.backward import append_backward as j_append_backward
from paddle_tpu.models.transformer_program import \
    build_transformer_program as j_build
from paddle_tpu_torch.core.desc import ProgramDesc
from paddle_tpu_torch.fluid import (MomentumOptimizer, Program,
                                    append_backward)
from paddle_tpu_torch.models.transformer_program import \
    build_transformer_program

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

SMALL = dict(batch=4, seq_len=32, vocab_size=64, n_layer=2, n_head=4,
             d_model=32)
FULL = dict(batch=16, seq_len=512, vocab_size=8192, n_layer=6, n_head=8,
            d_model=512)


def _jax_training_descs(cfg, causal=True, d_ff=None, nesterov=False):
    main, startup, avg_loss, logits = j_build(
        cfg["batch"], cfg["seq_len"], cfg["vocab_size"],
        n_layer=cfg["n_layer"], n_head=cfg["n_head"],
        d_model=cfg["d_model"], d_ff=d_ff, causal=causal)
    with jfluid.program_guard(main, startup):
        jfluid.optimizer.MomentumOptimizer(
            learning_rate=0.01, momentum=0.9,
            use_nesterov=nesterov).minimize(avg_loss)
    return main, startup, avg_loss.name, logits.name


def _port_training_descs(cfg, causal=True, d_ff=None, nesterov=False):
    main, startup, loss, logits = build_transformer_program(
        cfg["batch"], cfg["seq_len"], cfg["vocab_size"],
        n_layer=cfg["n_layer"], n_head=cfg["n_head"],
        d_model=cfg["d_model"], d_ff=d_ff, causal=causal)
    ops, params_grads = MomentumOptimizer(
        0.01, 0.9, use_nesterov=nesterov).minimize(loss, main, startup)
    return main, startup, loss, logits, ops, params_grads


@pytest.mark.parametrize("causal,d_ff,nesterov", [
    (True, None, False), (False, 48, False), (True, None, True)])
def test_training_descs_equal_jax(causal, d_ff, nesterov):
    jmain, jstartup, jloss, jlogits = _jax_training_descs(
        SMALL, causal, d_ff, nesterov)
    main, startup, loss, logits, ops, params_grads = _port_training_descs(
        SMALL, causal, d_ff, nesterov)
    assert (loss, logits) == (jloss, jlogits)
    assert main.to_dict() == jmain.desc.to_dict()
    assert startup.to_dict() == jstartup.desc.to_dict()
    # one momentum op per parameter, sorted by name
    params = sorted(n for n, v in main.block(0).vars.items()
                    if v.is_parameter)
    assert [p for p, _ in params_grads] == params
    assert [op.input("Param")[0] for op in ops] == params


def test_full_width_training_descs_equal_jax():
    jmain, jstartup, _, _ = _jax_training_descs(FULL)
    main, startup, _, _, _, _ = _port_training_descs(FULL)
    assert main.to_dict() == jmain.desc.to_dict()
    assert startup.to_dict() == jstartup.desc.to_dict()
    counts = {}
    for op in main.block(0).ops:
        counts[op.type] = counts.get(op.type, 0) + 1
    assert len(main.block(0).ops) == 290 and len(counts) == 23
    assert counts["flash_attention_grad"] == 6 and counts["sum"] == 12
    assert counts["momentum"] == 78 and counts["mul_grad"] == 25
    startup_counts = {}
    for op in startup.block(0).ops:
        startup_counts[op.type] = startup_counts.get(op.type, 0) + 1
    assert startup_counts == {"uniform_random": 27, "fill_constant": 130}


def _forward_fc_twice():
    x = jfluid.layers.data(name="x", shape=[6], dtype="float32")
    shared = jfluid.ParamAttr(name="shared_w")
    h = jfluid.layers.fc(input=x, size=6, param_attr=shared, act="relu")
    h = jfluid.layers.fc(input=h, size=6, param_attr=shared)
    return jfluid.layers.mean(x=x + h)


def _forward_sparse_embedding():
    ids = jfluid.layers.data(name="ids", shape=[3, 1], dtype="int64",
                             append_batch_size=False)
    e = jfluid.layers.embedding(ids, size=[10, 4], is_sparse=True)
    e2 = jfluid.layers.embedding(ids, size=[10, 4], padding_idx=0)
    return jfluid.layers.mean(x=jfluid.layers.fc(input=e + e2, size=2))


def _forward_loss():
    x = jfluid.layers.data(name="x", shape=[4, 5], dtype="float32",
                           append_batch_size=False)
    y = jfluid.layers.data(name="y", shape=[4, 1], dtype="int64",
                           append_batch_size=False)
    logits = jfluid.layers.fc(input=x, size=3)
    flat = jfluid.layers.reshape(x=logits, shape=[-1, 3])
    return jfluid.layers.mean(
        x=jfluid.layers.softmax_with_cross_entropy(flat, y))


@pytest.mark.parametrize("forward,kwargs", [
    (_forward_fc_twice, {}),
    (_forward_sparse_embedding, {}),
    (_forward_loss, {}),
    (_forward_fc_twice, {"no_grad_set": ["fc_0.tmp_0"]}),
    (_forward_loss, {"parameter_list": ["fc_0.w_0"]})],
    ids=["shared_param", "sparse_embedding", "loss", "no_grad_set",
         "parameter_list"])
def test_append_backward_equals_jax(forward, kwargs):
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        loss = forward()
    port = Program.from_desc(
        ProgramDesc.parse_from_string(main.desc.serialize_to_string()))
    with jfluid.program_guard(main, startup):
        jpg = j_append_backward(loss, **kwargs)
    pg = append_backward(port.global_block().var(loss.name), **kwargs)
    assert port.desc.to_dict() == main.desc.to_dict()
    assert [(p.name, g.name) for p, g in pg] \
        == [(p.name, g.name) for p, g in jpg]
