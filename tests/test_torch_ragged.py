"""Ragged (LoD) values in the port against the JAX package, on the CPU.

- `RaggedTensor` against the JAX package's on the same sequences (a
  numpy seed): `from_sequences` with and without a bucket, `lod()`,
  `segment_ids`, `valid_mask`, `seq_lengths`, `nvalid`, `max_seqlen`
  and `bucket_max_seqlen`; the torch pytree node, and the int64 guard.
- The ragged `DataFeeder` at lod levels 1 and 2, beside a dense slot,
  against the JAX package's feeder on the same samples.
- Ragged values in `.npz` files: each package reads what the other
  wrote (values, splits, `nvalid`), and checkpoints holding one.
- The executor's ragged feeds and fetches: moved to the place, int64
  ids narrowed to int32, a fetch back as a host RaggedTensor with bf16
  values widened to f32.

Every comparison is exact: the same numpy code on the same samples,
and integer offsets.
"""

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import jax.numpy as jnp
import paddle_tpu.fluid as jfluid
from paddle_tpu.core.ragged import RaggedTensor as JRagged
from paddle_tpu.core.ragged import bucket_max_seqlen as j_bucket
from paddle_tpu.fluid import io as jio
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.desc import ProgramDesc, VarDesc
from paddle_tpu_torch.core.ragged import RaggedTensor, bucket_max_seqlen
from paddle_tpu_torch.core.types import tensor_from_numpy
from paddle_tpu_torch.fluid import checkpoint as tckpt
from paddle_tpu_torch.fluid import io as tio
from paddle_tpu.fluid import checkpoint as jckpt

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

CPU = tfluid.CPUPlace()


def _seqs(seed, n=5, width=None, dtype=np.float32, lo=0, hi=9):
    """`n` sequences of 0..hi-lo rows (one empty), from a numpy seed."""
    rs = np.random.RandomState(seed)
    lengths = list(rs.randint(1, 12, size=n))
    lengths[2] = 0
    tail = () if width is None else (width,)
    if np.issubdtype(dtype, np.integer):
        return [rs.randint(lo, hi, size=(n_,) + tail).astype(dtype)
                for n_ in lengths]
    return [rs.randn(*((n_,) + tail)).astype(dtype) for n_ in lengths]


def _assert_same(t, j):
    """A port RaggedTensor equal to a JAX one: values, splits, nvalid
    and max_seqlen."""
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    assert t.values.dtype == getattr(torch, np.asarray(j.values).dtype.name)
    assert t.lod() == j.lod()
    assert all(rs.dtype == torch.int32 for rs in t.row_splits)
    assert int(t.nvalid) == int(j.nvalid)
    assert t.max_seqlen == j.max_seqlen
    assert t.lod_level == j.lod_level and t.nseq() == j.nseq()


@pytest.mark.parametrize("bucket", [None, 16, 64])
@pytest.mark.parametrize("width", [None, 3])
def test_from_sequences_matches_jax(bucket, width):
    seqs = _seqs(0, width=width)
    j = JRagged.from_sequences(seqs, bucket=bucket)
    t = RaggedTensor.from_sequences(seqs, bucket=bucket)
    _assert_same(t, j)
    np.testing.assert_array_equal(t.segment_ids().numpy(),
                                  np.asarray(j.segment_ids()))
    np.testing.assert_array_equal(t.valid_mask().numpy(),
                                  np.asarray(j.valid_mask()))
    np.testing.assert_array_equal(t.seq_lengths().numpy(),
                                  np.asarray(j.seq_lengths()))
    assert t.segment_ids().dtype == torch.int32
    if bucket:
        assert t.values.shape[0] % bucket == 0
        assert int(t.nvalid) < t.values.shape[0]
        # padding rows belong to the segment one past the last
        assert int(t.segment_ids()[-1]) == len(seqs)


def test_int_sequences_narrow_with_the_guard():
    seqs = _seqs(1, width=1, dtype=np.int64, hi=50)
    t = RaggedTensor.from_sequences(seqs, bucket=8)
    _assert_same(t, JRagged.from_sequences(seqs, bucket=8))
    assert t.values.dtype == torch.int32
    with pytest.raises(OverflowError, match="int32 range"):
        RaggedTensor.from_sequences([np.array([[2 ** 40]], np.int64)])


@pytest.mark.parametrize("lengths", [[], [0], [3], [1, 9, 8], [100, 7],
                                     [129]])
def test_bucket_max_seqlen_matches_jax(lengths):
    assert bucket_max_seqlen(lengths) == j_bucket(lengths)


def test_lod2_structure_matches_jax():
    splits = [np.array([0, 2, 3], np.int32),
              np.array([0, 2, 5, 6], np.int32)]
    vals = np.arange(8 * 2, dtype=np.float32).reshape(8, 2)
    j = JRagged(jnp.asarray(vals), splits, nvalid=6)
    t = RaggedTensor(torch.from_numpy(vals), splits, nvalid=6)
    for level in (0, 1, -1):
        np.testing.assert_array_equal(t.segment_ids(level).numpy(),
                                      np.asarray(j.segment_ids(level)))
        np.testing.assert_array_equal(t.seq_lengths(level).numpy(),
                                      np.asarray(j.seq_lengths(level)))
    assert t.lod() == j.lod() and t.nseq(0) == 2 and t.nseq(1) == 3
    # the default nvalid is the last offset
    assert int(RaggedTensor(torch.from_numpy(vals), splits).nvalid) == 6


def test_pytree_node_round_trips():
    t = RaggedTensor.from_sequences(_seqs(2, width=2), bucket=16)
    leaves, spec = pytree.tree_flatten(t)
    assert len(leaves) == 3 and all(isinstance(x, torch.Tensor)
                                    for x in leaves)
    back = pytree.tree_unflatten(leaves, spec)
    assert isinstance(back, RaggedTensor) and back.max_seqlen == t.max_seqlen
    assert back.lod() == t.lod() and back.values is t.values
    doubled = pytree.tree_map(
        lambda x: x * 2 if x.is_floating_point() else x, t)
    assert torch.equal(doubled.values, t.values * 2)
    assert doubled.lod() == t.lod() and int(doubled.nvalid) == int(t.nvalid)
    moved = t.to("cpu")
    assert moved.max_seqlen == t.max_seqlen and moved.lod() == t.lod()


# -- the ragged DataFeeder ----------------------------------------------------

def _feed_vars(fluid):
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        words = fluid.layers.data(name="words", shape=[1], dtype="int64",
                                  lod_level=1)
        para = fluid.layers.data(name="para", shape=[1], dtype="int64",
                                 lod_level=2)
        feats = fluid.layers.data(name="feats", shape=[3], dtype="float32",
                                  lod_level=1)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    return main, [words, para, feats, label]


def _rows(n, seed):
    rs = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        words = rs.randint(0, 100, size=(rs.randint(0 if i == 1 else 1, 9),
                                         1)).astype(np.int64)
        para = [list(rs.randint(0, 100, size=rs.randint(1, 5)))
                for _ in range(rs.randint(1, 4))]
        feats = rs.randn(rs.randint(1, 6), 3).astype(np.float32)
        rows.append((words, para, feats, int(rs.randint(0, 2))))
    return rows


@pytest.mark.parametrize("bucket", [64, 8, 0])
def test_ragged_data_feeder_matches_jax(bucket):
    jmain, jvars = _feed_vars(jfluid)
    tmain, tvars = _feed_vars(tfluid)
    rows = _rows(4, seed=bucket)
    jfeed = jfluid.DataFeeder(jvars, jfluid.CPUPlace(), jmain,
                              ragged_bucket=bucket).feed(rows)
    tfeed = tfluid.DataFeeder(tvars, CPU, tmain,
                              ragged_bucket=bucket).feed(rows)
    assert set(tfeed) == set(jfeed)
    for name in ("words", "para", "feats"):
        _assert_same(tfeed[name], jfeed[name])
    assert tfeed["para"].lod_level == 2
    np.testing.assert_array_equal(tfeed["label"].numpy(),
                                  np.asarray(jfeed["label"]))


def test_ragged_data_feeder_guards_int64():
    tmain, tvars = _feed_vars(tfluid)
    rows = _rows(2, seed=3)
    rows[0] = (np.array([[2 ** 40]], np.int64),) + rows[0][1:]
    with pytest.raises(OverflowError, match="int32 range"):
        tfluid.DataFeeder(tvars, CPU, tmain).feed(rows)


# -- npz files ----------------------------------------------------------------

def _ragged_pair(lod_level, dtype):
    """(port RaggedTensor, JAX RaggedTensor) over the same arrays."""
    if lod_level == 1:
        seqs = _seqs(4, width=2, dtype=dtype, hi=30)
        return (RaggedTensor.from_sequences(seqs, bucket=16),
                JRagged.from_sequences(seqs, bucket=16))
    splits = [np.array([0, 1, 3], np.int32),
              np.array([0, 2, 2, 5], np.int32)]
    vals = np.arange(7 * 2).reshape(7, 2).astype(dtype)
    return (RaggedTensor(tensor_from_numpy(vals, "cpu"), splits,
                         nvalid=5),
            JRagged(jnp.asarray(vals), splits, nvalid=5))


@pytest.mark.parametrize("lod_level", [1, 2])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_ragged_npz_crosses_both_ways(lod_level, dtype, tmp_path):
    t, j = _ragged_pair(lod_level, dtype)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jio._save_one(str(tmp_path / "jax"), "r/x", j)
    tio._save_one(str(tmp_path / "port"), "r/x", t)
    got = tio._load_one(str(tmp_path / "jax"), "r/x")
    back = jio._load_one(str(tmp_path / "port"), "r/x")
    for a, b in ((got, j), (t, back)):
        np.testing.assert_array_equal(np.asarray(a.values),
                                      np.asarray(b.values))
        assert a.lod() == b.lod() and int(a.nvalid) == int(b.nvalid)
    assert isinstance(got, RaggedTensor) and got.max_seqlen is None
    # the files hold the same arrays under the same keys
    a = np.load(str(tmp_path / "jax" / "r_x.npz"))
    b = np.load(str(tmp_path / "port" / "r_x.npz"))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype, k


def _state_program(fluid):
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        v = fluid.layers.data(name="seqs", shape=[2], dtype="float32",
                              lod_level=1)
        v.persistable = True
    return main


def test_ragged_persistable_checkpoints_cross(tmp_path):
    t, j = _ragged_pair(1, np.float32)
    scope = tfluid.Scope()
    scope.set("seqs", t)
    saver = tckpt.CheckpointSaver(str(tmp_path / "port"),
                                  main_program=_state_program(tfluid))
    saver.save(3, scope)
    saver.wait()
    from paddle_tpu.core.scope import Scope as JScope

    jscope = JScope()
    assert jckpt.load_checkpoint(str(tmp_path / "port"), jscope) == 3
    got = jscope.get("seqs")
    np.testing.assert_array_equal(np.asarray(got.values), t.values.numpy())
    assert got.lod() == t.lod()
    jscope.set("seqs", j)
    jsaver = jckpt.CheckpointSaver(str(tmp_path / "jax"),
                                   main_program=_state_program(jfluid))
    jsaver.save(4, jscope)
    jsaver.wait()
    scope2 = tfluid.Scope()
    assert tckpt.load_checkpoint(str(tmp_path / "jax"), scope2,
                                 place=CPU) == 4
    back = scope2.get("seqs")
    assert isinstance(back, RaggedTensor) and back.lod() == j.lod()
    np.testing.assert_array_equal(back.values.numpy(), np.asarray(j.values))


# -- the executor's ragged feeds and fetches ----------------------------------

def _identity_program(dtype):
    """No ops: fetching the feed `x` gives it back as the run holds it."""
    prog = ProgramDesc()
    prog.block(0).vars["x"] = VarDesc("x", dtype=dtype, shape=(-1, 2),
                                      lod_level=1)
    return prog


def test_executor_feeds_and_fetches_ragged():
    seqs = _seqs(5, width=2, dtype=np.int64, hi=40)
    feed = RaggedTensor(torch.from_numpy(np.concatenate(seqs)),
                        [np.cumsum([0] + [len(s) for s in seqs])],
                        max_seqlen=16)
    exe = tfluid.Executor(CPU)
    out, = exe.run(_identity_program("int64"), feed={"x": feed},
                   fetch_list=["x"], scope=tfluid.Scope())
    assert isinstance(out, RaggedTensor) and out.values.dtype == torch.int32
    assert out.lod() == feed.lod() and out.max_seqlen == 16
    np.testing.assert_array_equal(out.values.numpy(),
                                  np.concatenate(seqs).astype(np.int32))
    big = feed.with_values(feed.values.clone())
    big.values[0, 0] = 2 ** 40
    with pytest.raises(OverflowError, match="int32 range"):
        exe.run(_identity_program("int64"), feed={"x": big},
                fetch_list=["x"], scope=tfluid.Scope())


def test_bf16_ragged_fetch_widens_to_f32():
    rt = RaggedTensor.from_sequences(_seqs(6, width=2), bucket=8)
    rt = rt.with_values(rt.values.to(torch.bfloat16))
    out, = tfluid.Executor(CPU).run(
        _identity_program("bfloat16"), feed={"x": rt}, fetch_list=["x"],
        scope=tfluid.Scope())
    assert out.values.dtype == torch.float32
    np.testing.assert_array_equal(out.values.numpy(),
                                  rt.values.float().numpy())
    assert out.lod() == rt.lod() and int(out.nvalid) == int(rt.nvalid)
