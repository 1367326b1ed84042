"""The port's ProgramDesc (paddle_tpu_torch.core.desc) against the JAX
package's: programs serialized by the JAX package parse unchanged in
the port and give back the same dict, and the port's directly built
transformer inference desc equals the JAX package's pruned one.
Exact equality throughout: these are data, not arithmetic.
"""

import json
import os

import pytest

from paddle_tpu.core import desc as jdesc
from paddle_tpu.fluid import io as jio
from paddle_tpu.models.transformer_program import build_transformer_program
from paddle_tpu_torch.core import desc as tdesc
from paddle_tpu_torch.core import types as ttypes
from paddle_tpu_torch.models.transformer_program import (
    build_transformer_inference_program, logits_name)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
GOLDEN = ["conv_classifier", "deepfm", "dynamic_rnn", "fit_a_line",
          "transformer"]


@pytest.mark.parametrize("case", GOLDEN)
def test_golden_program_parses_unchanged(case):
    with open(os.path.join(GOLDEN_DIR, case + ".json")) as f:
        d = json.load(f)
    ported = tdesc.ProgramDesc.from_dict(d)
    ref = jdesc.ProgramDesc.from_dict(d)
    assert ported.to_dict() == ref.to_dict()
    assert ported.serialize_to_string() == ref.serialize_to_string()
    assert json.loads(ported.serialize_to_string()) == d


def test_sub_block_refs_round_trip():
    with open(os.path.join(GOLDEN_DIR, "dynamic_rnn.json")) as f:
        d = json.load(f)
    ported = tdesc.ProgramDesc.from_dict(d)
    refs = [v for b in ported.blocks for op in b.ops
            for v in op.attrs.values() if isinstance(v, tdesc.BlockRef)]
    assert refs and all(0 < r.idx < len(ported.blocks) for r in refs)
    again = tdesc.ProgramDesc.parse_from_string(
        ported.serialize_to_string())
    assert again.to_dict() == ported.to_dict()


def test_jax_serialized_training_program_parses():
    main, _, _, _ = build_transformer_program(2, 8, 16, n_layer=1,
                                              n_head=2, d_model=8)
    s = main.desc.serialize_to_string()
    ported = tdesc.ProgramDesc.parse_from_string(s)
    assert ported.to_dict() == main.desc.to_dict()
    assert ported.serialize_to_string() == s
    back = jdesc.ProgramDesc.parse_from_string(
        ported.serialize_to_string())
    assert back.to_dict() == main.desc.to_dict()


@pytest.mark.parametrize("batch,seq,vocab,n_layer,n_head,d_model,d_ff", [
    (4, 32, 64, 2, 4, 32, None), (2, 16, 50, 1, 2, 16, 24),
    (3, 8, 20, 3, 1, 8, None), (16, 512, 8192, 6, 8, 512, None)])
def test_port_built_inference_desc_equals_jax_pruned(
        batch, seq, vocab, n_layer, n_head, d_model, d_ff):
    main, _, _, logits = build_transformer_program(
        batch, seq, vocab, n_layer=n_layer, n_head=n_head, d_model=d_model,
        d_ff=d_ff)
    pruned = jio.prune_program(main, [logits])
    ported = build_transformer_inference_program(
        batch, seq, vocab, n_layer=n_layer, n_head=n_head, d_model=d_model,
        d_ff=d_ff)
    assert ported.to_dict() == pruned.desc.to_dict()
    assert logits.name == logits_name(n_layer)


def test_full_width_program_op_set():
    prog = build_transformer_inference_program(16, 512, 8192, n_layer=6,
                                               n_head=8, d_model=512)
    counts = {}
    for op in prog.block(0).ops:
        counts[op.type] = counts.get(op.type, 0) + 1
    assert counts == {"elementwise_add": 38, "mul": 25, "layer_norm": 13,
                      "split": 6, "flash_attention": 6, "relu": 6,
                      "lookup_table": 2}


@pytest.mark.parametrize("declared,executes", [
    ("int64", "int32"), ("float64", "float32"), ("float32", "float32"),
    ("long", "int32"), ("bfloat16", "bfloat16")])
def test_exec_dtype_matches_jax(declared, executes):
    from paddle_tpu.core import types as jtypes

    assert ttypes.exec_dtype(declared) == jtypes.exec_dtype(declared) \
        == executes


def test_int64_narrowing_is_loud():
    import numpy as np

    ttypes.guard_int64_narrowing(np.array([2 ** 31 - 1], np.int64))
    with pytest.raises(OverflowError):
        ttypes.guard_int64_narrowing(np.array([2 ** 31], np.int64))
    with pytest.raises(OverflowError):
        ttypes.guard_int64_narrowing(np.array([-2 ** 31 - 1], np.int64))


def test_scope_matches_jax_scope_semantics():
    from paddle_tpu.core.scope import Scope as JScope
    from paddle_tpu_torch.core.scope import Scope as TScope

    for Scope in (JScope, TScope):
        root = Scope()

        root.set("w", 1)
        kid = root.new_scope()
        assert kid.find_var("w") is root and kid.get("w") == 1
        kid.set("w", 2)  # the nearest scope holding it
        assert root.get("w") == 2 and "w" in kid
        kid.set("x", 3)  # else locally
        assert root.get("x") is None and kid.get("x") == 3
        kid.var("y")
        assert kid.has_var("y") and kid.get("y") is None
