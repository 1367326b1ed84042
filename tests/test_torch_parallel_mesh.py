"""The parallel package's static layer against the JAX package's, in one
process (no ranks spawned).

- `parse_mesh_spec` and `MeshConfig`: axes, shapes, reprs and errors.
- `make_mesh`'s axis names, order, sizes and errors, through
  `mesh_layout` (its arithmetic apart from the ranks) against the JAX
  `make_mesh` over the virtual CPU devices, for the default, extended,
  `drop_unit_axes` and custom-name meshes; the error for more ranks
  than the world has; a real DeviceMesh at world 1 (a gloo group over a
  `file://` store, started by `make_mesh` itself) with the JAX mesh's
  axis names; the CUDA default raising without a device.
- `param_spec`, `param_spec_reason`, `zero1_spec`, `zero1_spec_reason`
  and `batch_spec` for the cases of `tests/test_parallel_trainer.py`
  and the boundaries of `tests/test_spmd.py`, reasons' text included.
- `sp_axis_info`, `pipeline_schedule_info`, `moe_axis_info`,
  `expert_capacity` and `grad_buckets`.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu.parallel import moe as jmoe
from paddle_tpu.parallel import pipeline as jpipe
from paddle_tpu.parallel import ring as jring
from paddle_tpu.parallel import sharding as jshard
from paddle_tpu_torch.parallel import mesh as tmesh
from paddle_tpu_torch.parallel import moe as tmoe
from paddle_tpu_torch.parallel import pipeline as tpipe
from paddle_tpu_torch.parallel import ring as tring
from paddle_tpu_torch.parallel import sharding as tshard

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def world_of_one():
    """The world-1 group the cases below make; gone afterwards, so later
    tests in this process start without one."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def _error(fn, *args, **kwargs):
    with pytest.raises(Exception) as info:
        fn(*args, **kwargs)
    return type(info.value).__name__, str(info.value)


SPECS = ["dp=4,mp=2", "mp=2,dp=4", "dp=8", "dp=2,sp=2,pp=2",
         " dp = 2 , ep = 4 ,", "sp=4"]
BAD_SPECS = ["dp4", "xp=2", "dp=two", "dp=0", "dp=2,dp=2", ",", ""]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_mesh_spec_equals_jax(spec):
    j, t = jmesh.parse_mesh_spec(spec), tmesh.parse_mesh_spec(spec)
    assert t.axes == j.axes
    assert dict(t.shape) == dict(j.shape) and list(t.shape) == list(j.shape)
    assert repr(t) == repr(j)
    assert tmesh.MeshConfig.parse(spec).axes == j.axes


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_mesh_spec_errors_equal_jax(spec):
    assert _error(tmesh.parse_mesh_spec, spec) == \
        _error(jmesh.parse_mesh_spec, spec)


@pytest.mark.parametrize("kw", [{}, {"dp": 4, "mp": 2}, {"sp": 2},
                                {"dp": None, "pp": 2, "ep": 2},
                                {"axes": ("dp", "mp", "sp"), "sp": 4}])
def test_mesh_config_equals_jax(kw):
    j, t = jmesh.MeshConfig(**kw), tmesh.MeshConfig(**kw)
    assert t.axes == j.axes and dict(t.shape) == dict(j.shape)
    for n in (4, 8, 6):
        try:
            j.validate(n)
        except ValueError as exc:
            with pytest.raises(ValueError) as info:
                t.validate(n)
            assert str(info.value) == str(exc)
        else:
            assert t.validate(n) is t


LAYOUTS = [
    (8, {}), (8, {"mp": 2}), (4, {"mp": 4}), (8, {"sp": 2}),
    (8, {"mp": 2, "sp": 2}), (8, {"pp": 2, "ep": 2}),
    (8, {"dp": 2, "mp": 2, "sp": 2}), (8, {"ep": 8}),
    (8, {"mp": 2, "drop_unit_axes": True}),
    (8, {"sp": 2, "drop_unit_axes": True}),
    (4, {"drop_unit_axes": True}), (1, {}), (1, {"drop_unit_axes": True}),
    (8, {"axes": ("data", "model"), "mp": 2}),
    (8, {"axes": ("dp", "mp", "sp", "pp", "ep"), "sp": 2, "pp": 2}),
    (4, {"axes": ("mp", "sp"), "mp": 2, "sp": 2}),
    (8, {"axes": ("dp", "mp", "sp", "pp", "ep"), "mp": 2,
         "drop_unit_axes": True}),
]
BAD_LAYOUTS = [
    (8, {"mp": 3}), (8, {"dp": 2, "mp": 2}), (8, {"dp": 3, "sp": 2}),
    (8, {"axes": ("a", "b", "c")}), (8, {"axes": ("x", "y"), "sp": 2}),
    (8, {"axes": ("dp", "mp"), "sp": 2}), (6, {"axes": ("x", "y"),
                                               "mp": 4}),
]


@pytest.mark.parametrize("n,kw", LAYOUTS)
def test_mesh_layout_equals_jax_make_mesh(n, kw):
    jm = jmesh.make_mesh(n_devices=n, **kw)
    axes, sizes = tmesh.mesh_layout(n, **kw)
    assert axes == tuple(jm.axis_names)
    assert sizes == dict(jm.shape)


@pytest.mark.parametrize("n,kw", BAD_LAYOUTS)
def test_mesh_layout_errors_equal_jax(n, kw):
    assert _error(tmesh.mesh_layout, n, **kw) == \
        _error(jmesh.make_mesh, n_devices=n, **kw)


def test_cuda_mesh_raises_without_a_device(tmp_path):
    """The mesh's default device is the card: without one, make_mesh
    and init_multihost raise naming CUDA and start no group (there is no
    fallback to gloo)."""
    from paddle_tpu_torch import distributed as tdist

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.backend_for("cuda")
    assert tmesh.backend_for("cpu") == "gloo"
    if not torch.distributed.is_initialized():
        with pytest.raises(RuntimeError, match="CUDA"):
            tdist.init_multihost(
                coordinator="file://%s" % (tmp_path / "store"),
                num_processes=1, process_id=0)
        assert not torch.distributed.is_initialized()


def test_make_mesh_at_world_one():
    """A DeviceMesh over a world of one CPU rank that make_mesh starts
    itself: the JAX mesh's axis names at that size; more ranks than the
    world raise naming its size."""
    for kw in ({}, {"drop_unit_axes": True}, {"axes": ("data", "model")},
               {"axes": ("dp", "mp", "sp", "pp", "ep"),
                "drop_unit_axes": True}):
        mesh = tmesh.make_mesh(device="cpu", **kw)
        jm = jmesh.make_mesh(n_devices=1, **kw)
        assert mesh.mesh_dim_names == tuple(jm.axis_names)
        assert dict(tmesh.mesh_shape(mesh)) == dict(jm.shape)
        assert mesh.device_type == "cpu"
    assert torch.distributed.get_backend() == "gloo"
    assert torch.distributed.get_world_size() == 1
    with pytest.raises(ValueError, match="world has 1 rank"):
        tmesh.make_mesh(n_devices=4, device="cpu")
    with pytest.raises(ValueError, match="mp=2"):
        tmesh.make_mesh(n_devices=1, mp=2, device="cpu")


def _spec(s):
    return tuple(s)


PARAM_CASES = [
    ("w", (8, 1024)), ("emb", (4096, 128)), ("fc_w", (256, 1024)),
    ("fc_b", (64,)), ("small_w", (32, 48)), ("conv_w", (64, 3, 3, 3)),
    ("w", (1024, 1023)), ("w", (1024, 1024)), ("w", (1024, 1025)),
    ("w", (512, 512)), ("w", (512, 511)), ("w", (511, 511)),
    ("w", (515, 515)), ("w", (2048, 513)), ("w", (513, 2048)),
    ("w", (600, 100)),
]
MESHES = ["dp=4,mp=2", "dp=8", "mp=2", "dp=2,mp=4", "mp=1,dp=8"]


@pytest.mark.parametrize("mesh", MESHES)
def test_param_spec_and_reason_equal_jax(mesh):
    jm, tm = jmesh.parse_mesh_spec(mesh), tmesh.parse_mesh_spec(mesh)
    for name, shape in PARAM_CASES:
        js, jr = jshard.param_spec_reason(name, shape, jm)
        ts, tr = tshard.param_spec_reason(name, shape, tm)
        assert (_spec(ts), tr) == (_spec(js), jr), (mesh, shape)
        assert _spec(tshard.param_spec(name, shape, tm)) == \
            _spec(jshard.param_spec(name, shape, jm))


def test_param_spec_on_the_jax_tests_meshes():
    """tests/test_parallel_trainer.py:106-129, on real meshes there and
    static ones here."""
    jm = jmesh.make_mesh(n_devices=8, mp=2)
    tm = tmesh.MeshConfig(dp=4, mp=2)
    for name, shape in PARAM_CASES:
        assert _spec(tshard.param_spec(name, shape, tm)) == \
            _spec(jshard.param_spec(name, shape, jm))
    assert _spec(tshard.param_spec("w", (8, 1024), tm)) == (None, "mp")
    dp_only = tmesh.MeshConfig(dp=8)
    assert _spec(tshard.param_spec("emb", (4096, 128), dp_only)) == ()


ZERO_CASES = [
    ((), (8,), "dp=8"), ((), (), "dp=8"), ((), (7, 9), "dp=8"),
    (("mp", None), (1024, 1024), "dp=4,mp=2"), ((), (8,), "mp=2"),
    ((None, "mp"), (6, 1024), "dp=4,mp=2"), ((), (1024, 4), "dp=4,mp=2"),
    ((), (3, 5), "dp=1"), (("mp",), (4096, 2), "dp=2,mp=2"),
]


@pytest.mark.parametrize("base,shape,mesh", ZERO_CASES)
def test_zero1_spec_and_reason_equal_jax(base, shape, mesh):
    jm, tm = jmesh.parse_mesh_spec(mesh), tmesh.parse_mesh_spec(mesh)
    js, jr = jshard.zero1_spec_reason(jshard.P(*base), shape, jm)
    ts, tr = tshard.zero1_spec_reason(tshard.P(*base), shape, tm)
    assert (_spec(ts), tr) == (_spec(js), jr)
    assert _spec(tshard.zero1_spec(tshard.P(*base), shape, tm)) == \
        _spec(jshard.zero1_spec(jshard.P(*base), shape, jm))


def test_batch_spec_equals_jax():
    for mesh in ("dp=4,mp=2", "mp=2", "dp=8"):
        jm, tm = jmesh.parse_mesh_spec(mesh), tmesh.parse_mesh_spec(mesh)
        for shape in ((16, 3, 32, 32), (), (16, 4)):
            assert _spec(tshard.batch_spec(shape, tm)) == \
                _spec(jshard.batch_spec(shape, jm))
    no_dp = {"x": 4, "mp": 2}
    assert _spec(tshard.batch_spec((16, 4), no_dp)) == ()


def test_optimizer_state_names_and_regex_equal_jax():
    import paddle_tpu.fluid as jfluid
    import paddle_tpu_torch.fluid as tfluid

    names = {}
    for fluid, key in ((jfluid, "jax"), (tfluid, "port")):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            y = fluid.layers.fc(input=x, size=3)
            loss = fluid.layers.mean(y)
            fluid.optimizer.Adam(learning_rate=0.1).minimize(loss)
        mod = jshard if key == "jax" else tshard
        names[key] = mod.optimizer_state_names(main)
    assert names["port"] == names["jax"] and names["port"]
    for n in ("fc_0.w_0_moment1_0", "fc_0.w_0", "a_velocity_12",
              "b_squared_3", "c_linear_0", "d_moment_x"):
        assert tshard.is_optimizer_state(n) == jshard.is_optimizer_state(n)


def test_spec_placements():
    """A spec's DTensor placements on a mesh of named axes."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = tmesh.make_mesh(device="cpu", axes=("dp", "mp"))
    assert tshard.placements(mesh, tshard.P()) == [Replicate(), Replicate()]
    assert tshard.placements(mesh, tshard.P(None, "mp")) == \
        [Replicate(), Shard(1)]
    assert tshard.placements(mesh, tshard.P(("dp", "mp"))) == \
        [Shard(0), Shard(0)]
    with pytest.raises(ValueError, match="lacks"):
        tshard.placements(mesh, tshard.P("sp"))
    with pytest.raises(NotImplementedError):
        tshard.placements(mesh, tshard.P(("mp", "dp")))
    assert repr(tshard.P("dp", None)) == "P('dp', None)"


INFO_MESHES = [{"sp": 4}, {"dp": 2, "sp": 2}, {"dp": 4}, {"pp": 4},
               {"pp": 2, "dp": 2}, {"ep": 4}, {"dp": 2, "ep": 4}]


@pytest.mark.parametrize("shape", INFO_MESHES)
def test_axis_infos_equal_jax(shape):
    for mode in ("ring", "ulysses"):
        for seq, heads in ((64, 4), (30, 6), (None, None)):
            assert tring.sp_axis_info(shape, seq, heads, mode=mode) == \
                jring.sp_axis_info(shape, seq, heads, mode=mode)
    for m, b in ((4, 16), (6, 24), (3, None), (5, 12)):
        assert tpipe.pipeline_schedule_info(shape, m, batch_size=b) == \
            jpipe.pipeline_schedule_info(shape, m, batch_size=b)
    for e, tokens in ((8, 64), (4, 30), (6, None)):
        for cf in (1.25, 0.5, 8.0):
            assert tmoe.moe_axis_info(shape, e, capacity_factor=cf,
                                      tokens=tokens) == \
                jmoe.moe_axis_info(shape, e, capacity_factor=cf,
                                   tokens=tokens)


def test_expert_capacity_and_grad_buckets_equal_jax():
    for tokens in (1, 7, 32, 1000):
        for e in (0, 1, 8, 64):
            for cf in (0.25, 1.0, 1.25, 8.0):
                assert tmoe.expert_capacity(tokens, e, cf) == \
                    jmoe.expert_capacity(tokens, e, cf)
    rs = np.random.RandomState(0)
    sized = [("g%d" % i, int(s)) for i, s in
             enumerate(rs.randint(1, 5000, size=40))]
    for cap in (1, 1000, 4096, 10 ** 6):
        assert tring.grad_buckets(sized, cap) == \
            jring.grad_buckets(sized, cap)
    assert tring.grad_buckets([], 10) == jring.grad_buckets([], 10)


def test_bucketed_allreduce_and_verify_sharding_wait():
    """The pieces that waited with the next slice's modules run as the
    JAX package's do: `bucketed_allreduce` of nothing is nothing, and
    `verify_sharding` over a static mesh rejects a batch of 6 at dp=4
    with the JAX gate's S002 error, word for word."""
    import paddle_tpu.fluid as jfluid
    from paddle_tpu import analysis as janalysis
    from paddle_tpu.parallel import trainer as jtrainer
    import paddle_tpu_torch.fluid as tfluid
    from paddle_tpu_torch import analysis as tanalysis
    from paddle_tpu_torch.parallel import trainer as ttrainer
    from paddle_tpu_torch.utils import flags

    assert tring.bucketed_allreduce({}, 1024) == {} == \
        jring.bucketed_allreduce({}, 1024)
    errors = []
    for fl, tr, an in ((tfluid, ttrainer, tanalysis),
                       (jfluid, jtrainer, janalysis)):
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = fl.layers.data(name="x", shape=[6, 64], dtype="float32",
                               append_batch_size=False)
            loss = fl.layers.mean(x=fl.layers.fc(input=x, size=64))
            fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
        with pytest.raises(an.ProgramVerificationError) as err:
            tr.verify_sharding(main, {"dp": 4, "mp": 2}, ["x"],
                               [loss.name])
        errors.append(str(err.value))
    assert "S002" in errors[0] and errors[0] == errors[1]
    assert flags.get_flag("verify_sharding") is False
