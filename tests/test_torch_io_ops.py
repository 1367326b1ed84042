"""The `feed`, `fetch`, `save` and `load` ops: the port against the JAX
package, on the CPU.

- A program that carries its own ops (feed, scale, fetch, save), built
  the same way in both packages: equal descs; run with the scope's
  "feed" list, its "fetch" list and saved file hold what the JAX
  package's hold, dense and ragged.
- Files crossing both ways: a file that either package's `save` op wrote
  is read by the other's `load` op to the same values (the same lod for
  a ragged value; the `np.savez` layout with `__ragged__`, `values`,
  `nvalid` and `rs<i>`); `overwrite=False` refuses an existing file on
  both.
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu.ops  # noqa: F401 — registers the JAX kernels
from paddle_tpu.core.ragged import RaggedTensor as JRagged
from paddle_tpu.core.scope import Scope as JScope
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.ragged import RaggedTensor as TRagged

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)


def _carrying(fluid, path, lod_level):
    """feed -> scale by 2 -> fetch and save, as the program's own ops."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        block = main.global_block()
        x = block.create_var(name="x", shape=[-1, 3], dtype="float32",
                             lod_level=lod_level)
        block.append_op(type="feed", inputs={}, outputs={"Out": [x]},
                        attrs={"col": 0})
        y = fluid.layers.scale(x=x, scale=2.0)
        block.append_op(type="fetch", inputs={"X": [y]}, outputs={},
                        attrs={"col": 1})
        block.append_op(type="save", inputs={"X": [y]}, outputs={},
                        attrs={"file_path": path})
    return main


def _load(fluid, path, lod_level):
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        block = main.global_block()
        out = block.create_var(name="loaded", shape=[-1, 3],
                               dtype="float32", lod_level=lod_level)
        block.append_op(type="load", inputs={}, outputs={"Out": [out]},
                        attrs={"file_path": path})
        block.append_op(type="fetch", inputs={"X": [out]}, outputs={},
                        attrs={"col": 0})
    return main


def _value(v):
    if isinstance(v, (JRagged, TRagged)):
        vals = v.values.numpy() if isinstance(v, TRagged) else \
            np.asarray(v.values)
        return vals[:int(np.asarray(v.nvalid))], v.lod()
    return np.asarray(v), None


def _run(fluid, scope_type, program, feed_value=None):
    scope = scope_type()
    if feed_value is not None:
        scope.set("feed", [feed_value])
    place = fluid.CPUPlace()
    fluid.Executor(place).run(program, scope=scope)
    return scope.get("fetch")


_DATA = np.random.RandomState(7).randn(5, 3).astype(np.float32)
_SEQS = [_DATA[:2], _DATA[2:5]]


@pytest.mark.parametrize("ragged", [False, True])
def test_program_carrying_its_own_ops(tmp_path, ragged):
    lod = 1 if ragged else 0
    paths = {k: str(tmp_path / k / "y") for k in ("jax", "port")}
    jm = _carrying(jfluid, paths["jax"], lod)
    tm = _carrying(tfluid, paths["port"], lod)
    jd, td = jm.desc.to_dict(), tm.desc.to_dict()
    for d in (jd, td):
        for op in d["blocks"][0]["ops"]:
            op["attrs"].pop("file_path", None)
    assert td == jd
    jfeed = JRagged.from_sequences(_SEQS) if ragged else _DATA
    tfeed = TRagged.from_sequences(_SEQS) if ragged else \
        torch.from_numpy(_DATA)
    jf = _run(jfluid, JScope, jm, jfeed)
    tf = _run(tfluid, tfluid.Scope, tm, tfeed)
    assert jf[0] is None and tf[0] is None and len(tf) == 2
    (jv, jlod), (tv, tlod) = _value(jf[1]), _value(tf[1])
    assert tlod == jlod
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tv, 2 * _DATA)
    for k in paths:
        assert os.path.exists(paths[k] + ".npz")


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_cross_both_ways(tmp_path, writer, ragged):
    lod = 1 if ragged else 0
    path = str(tmp_path / "sub" / "y")
    if writer == "jax":
        _run(jfluid, JScope, _carrying(jfluid, path, lod),
             JRagged.from_sequences(_SEQS) if ragged else _DATA)
    else:
        _run(tfluid, tfluid.Scope, _carrying(tfluid, path, lod),
             TRagged.from_sequences(_SEQS) if ragged else
             torch.from_numpy(_DATA))
    with np.load(path + ".npz") as data:
        assert int(data["__ragged__"]) == int(ragged)
        assert ("rs0" in data) == ragged and ("nvalid" in data) == ragged
    (jv, jlod), = [_value(v) for v in _run(jfluid, JScope,
                                           _load(jfluid, path, lod))]
    (tv, tlod), = [_value(v) for v in _run(tfluid, tfluid.Scope,
                                           _load(tfluid, path, lod))]
    assert tlod == jlod == ([[0, 2, 5]] if ragged else None)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tv, 2 * _DATA)


def test_save_refuses_to_overwrite(tmp_path):
    path = str(tmp_path / "y.npz")
    np.savez(path, __ragged__=0, values=_DATA)
    for fluid, scope_type, feed in ((jfluid, JScope, _DATA),
                                    (tfluid, tfluid.Scope,
                                     torch.from_numpy(_DATA))):
        main = _carrying(fluid, path, 0)
        main.desc.block(0).ops[-1].attrs["overwrite"] = False
        with pytest.raises(Exception, match="overwrite"):
            _run(fluid, scope_type, main, feed)
