"""DistributeTranspiler: the parameter-server layout as a graph rewrite.

Counterpart of paddle_tpu/distributed/transpiler.py (reference:
python/paddle/v2/fluid/distribute_transpiler.py:81 — parameters split
into blocks round-robin across pservers (split_dense_variable:39), the
trainer program's optimizer ops replaced by send; the pserver applies
the optimizer per shard).  As on the JAX side:

  * the transport is the native framed-TCP runtime (native.py), and
    the servers run the optimizers in C++ (reference:
    ParameterServer2.h:383 doOperation, go/pserver/optimizer.go);
  * the trainer's `dist_send` op (ops/dist.py) closes the block: the
    card computes the forward and backward, then the op ships each grad
    block, waits for the sync round and writes the fresh parameter back
    (reference: send_op.cc:35 / recv_op.cc:86);
  * a SelectedRows grad ships its rows only, and its table lives whole
    on one server (reference: getParameterSparse ParameterServer2.h:510).
"""

import warnings

import numpy as np
import torch

from .. import analysis, native
from ..core.desc import ProgramDesc
from ..core.scope import global_scope
from ..core.types import VarType
from ..fluid import framework, fusion
from ..ops.dist import ClientPool, block_name

__all__ = ["DistributeTranspiler", "split_dense_variable", "run_pserver"]

# optimizer op type -> the server's optimizer kind
_OPT_MAP = {
    "sgd": native.OPT_SGD,
    "momentum": native.OPT_MOMENTUM,
    "adagrad": native.OPT_ADAGRAD,
    "adam": native.OPT_ADAM,
}


def split_dense_variable(var_list, pserver_count, min_block_size=1024,
                         max_block_size=1 << 20):
    """Split parameters into near-equal blocks to balance pserver load
    (reference: distribute_transpiler.py split_dense_variable:39).

    Returns a list of (var_name, block_id, begin, size) over flattened
    elements.
    """
    blocks = []
    for var in var_list:
        size = int(np.prod(var.shape))
        split_count = pserver_count
        if size <= min_block_size:
            split_count = 1
        block_size = (size + split_count - 1) // split_count
        if block_size < min_block_size:
            block_size = min_block_size
        block_size = min(block_size, max_block_size)
        nblocks = (size + block_size - 1) // block_size
        for i in range(nblocks):
            begin = i * block_size
            blocks.append((var.name, i, begin,
                           min(block_size, size - begin)))
    return blocks


def _validate_split_blocks(assign, params, endpoints):
    """Every parameter's blocks must tile [0, numel) exactly:
    contiguous, non-overlapping, fully covering, each on a known
    endpoint.  A split_method that gets this wrong would otherwise
    surface as silently corrupted parameters after the first round
    trip; fail at transpile time instead, naming the parameter and the
    first bad block."""
    numel = {p.name: int(np.prod(p.shape)) for p in params}
    dropped = sorted(set(numel) - set(assign))
    if dropped:
        raise ValueError(
            "split assigned no pserver blocks to parameter(s) %s — "
            "they would silently stay at their initial values on "
            "every trainer" % dropped)
    for pname, blocks in assign.items():
        total = numel.get(pname)
        if total is None:
            raise ValueError(
                "split assigned blocks to %r, which is not a "
                "parameter being distributed" % pname)
        cursor = 0
        for ep, begin, size in sorted(blocks, key=lambda b: b[1]):
            if ep not in endpoints:
                raise ValueError(
                    "param %r block [%d:%d) is assigned to unknown "
                    "pserver endpoint %r" % (pname, begin,
                                             begin + size, ep))
            if size <= 0:
                raise ValueError(
                    "param %r has an empty/negative block at offset "
                    "%d (size %d)" % (pname, begin, size))
            if begin != cursor:
                kind = "overlaps" if begin < cursor else "leaves a gap"
                raise ValueError(
                    "param %r split %s at offset %d: block [%d:%d) "
                    "after [..:%d)" % (pname, kind, cursor, begin,
                                       begin + size, cursor))
            cursor = begin + size
        if cursor != total:
            raise ValueError(
                "param %r split covers %d of %d elements — the "
                "pserver would train a truncated parameter"
                % (pname, cursor, total))


def _optimizer_config(op):
    """(server kind, LR var name, (hp1, hp2, hp3)) of an update op."""
    attrs = op.desc.attrs
    if op.type == "momentum":
        hp = (float(attrs.get("mu", 0.9)), 0.0, 0.0)
    elif op.type == "adagrad":
        hp = (float(attrs.get("epsilon", 1e-6)), 0.0, 0.0)
    elif op.type == "adam":
        hp = (float(attrs.get("beta1", 0.9)),
              float(attrs.get("beta2", 0.999)),
              float(attrs.get("epsilon", 1e-8)))
    else:
        hp = (0.0, 0.0, 0.0)
    return _OPT_MAP[op.type], op.desc.input("LearningRate")[0], hp


def _warn_on_lr_schedule(block, opt_ops, lr_names):
    """The server snapshots the LR once at init_pservers; an op in the
    trainer program that evolves the LR var (a decay schedule) would
    have no effect on the updates (the reference ships the current LR
    with every update — ParameterServer2 trainingConfig).  Warn."""
    written = {}
    for op in block.ops:
        if op in opt_ops:
            continue
        for outs in op.desc.outputs.values():
            for o in outs:
                written.setdefault(o, []).append(op)

    def static_src(n):
        # produced by no op and persistable (a parameter or constant);
        # a non-persistable var no op produces is a feed: dynamic
        if written.get(n):
            return False
        vd = block.desc.vars.get(n)
        return vd is not None and bool(vd.persistable)

    def static_writer(op):
        # constant producers (fill_constant LR vars, the per-parameter
        # `scale` of Optimizer._create_param_lr) give the same value
        # every step; an op updating one of its own inputs in place, or
        # reading what other ops produce (step counters), evolves
        in_names = [i for ins in op.desc.inputs.values() for i in ins]
        out_names = [o for outs in op.desc.outputs.values() for o in outs]
        if any(o in in_names for o in out_names):
            return False
        return all(static_src(i) for i in in_names)

    decay_writers = [op.type for name in lr_names
                     for op in written.get(name, [])
                     if not static_writer(op)]
    if decay_writers:
        warnings.warn(
            "DistributeTranspiler: ops %s write the learning-rate "
            "var, but the pserver optimizer snapshots LR once at "
            "init_pservers(); the decay schedule will NOT affect "
            "pserver updates. Re-run init_pservers() to refresh, "
            "or keep the optimizer local." % sorted(set(decay_writers)),
            stacklevel=3)


def _var_name(v):
    return v if isinstance(v, str) else v.name


class DistributeTranspiler:
    """reference: distribute_transpiler.py DistributeTranspiler:81."""

    def __init__(self):
        self.param_blocks = {}     # param name -> [(endpoint, begin, size)]
        self.param_opt = {}        # param name -> (kind, lr var, hps)
        self.trainers = 1
        self.sync = True
        self._sparse_params = set()

    def transpile(self, optimize_ops=None, params_grads=None,
                  trainer_id=0, program=None, pservers="127.0.0.1:6174",
                  trainers=1, sync=True, sync_mode=None,
                  split_method=split_dense_variable):
        """Rewrite `program` (default: the default main program; a
        ProgramDesc is rewritten in place) for the pservers
        `pservers` ("host:port,..." or a list): its update ops go, one
        `dist_send` per parameter of `params_grads` ([(Parameter, grad
        Variable)] or names, as `minimize` returns them) comes last.
        Each update op's kind, LR var and hyper-parameters configure
        the parameter's server optimizer (sgd, momentum, adagrad or
        adam; any other raises NotImplementedError).  `fused_update`
        ops come apart first.

        sync_mode=False selects async SGD: each trainer's gradient
        applies at once server-side with no cross-trainer barrier
        (reference: ParameterServer2.h asyncSGD:468); pair with
        run_pserver(sync=False, async_lagged_threshold=N) to bound
        staleness (ParameterServer2.h:243).  `sync` is the older
        spelling; when both are given sync_mode wins.  `optimize_ops`
        is accepted for the reference's signature: the update ops are
        found in the program."""
        if program is None:
            program = framework.default_main_program()
        elif isinstance(program, ProgramDesc):
            program = framework.Program.from_desc(program)
        self.program = program
        self.trainer_id = trainer_id
        self.trainers = trainers
        self.sync = sync if sync_mode is None else bool(sync_mode)
        endpoints = (pservers.split(",") if isinstance(pservers, str)
                     else list(pservers))
        self.endpoints = endpoints

        block = program.global_block()
        # pserver placement scatters per-parameter update ops across
        # endpoints, so any stacked fused_update ops come apart first
        fusion.unfuse_update_ops(block)
        pairs = [(block.var(_var_name(p)), block.var(_var_name(g)))
                 for p, g in params_grads]
        params = [p for p, _ in pairs]
        grads = {p.name: g for p, g in pairs}

        opt_ops = [op for op in block.ops if op.type in _OPT_MAP]
        configured = {op.desc.input("Param")[0]: _optimizer_config(op)
                      for op in opt_ops}
        unsupported = [p.name for p in params if p.name not in configured]
        if unsupported:
            raise NotImplementedError(
                "pserver-side optimizer supports sgd/momentum/adagrad/"
                "adam; no config found for params %s" % unsupported)
        self.param_opt = configured
        _warn_on_lr_schedule(block, opt_ops,
                             {lr for _k, lr, _hp in configured.values()})

        # sparse-grad params stay whole on one endpoint (rows route to a
        # single owner; reference sparse tables also shard by row
        # server-set, not by flat range)
        sparse = {p.name for p in params
                  if grads[p.name].type == VarType.SELECTED_ROWS}
        self._sparse_params = sparse

        # param -> blocks -> endpoints, round-robin over the block list
        # (reference: round_robin distributed_spliter.py)
        dense_params = [p for p in params if p.name not in sparse]
        assign = {}
        for i, (pname, _bid, begin, size) in enumerate(
                split_method(dense_params, len(endpoints))):
            assign.setdefault(pname, []).append(
                (endpoints[i % len(endpoints)], begin, size))
        for j, p in enumerate(p for p in params if p.name in sparse):
            assign[p.name] = [(endpoints[j % len(endpoints)], 0,
                               int(np.prod(p.shape)))]
        # a bad split_method means every trainer ships wrong ranges to
        # every pserver: validate the tiling before the rewrite lands
        _validate_split_blocks(assign, params, set(endpoints))
        self.param_blocks = assign

        # drop the update ops (their LR helpers stay: harmless) and
        # append one dist_send per param
        removed = {id(op.desc) for op in opt_ops}
        block.desc.ops[:] = [d for d in block.desc.ops
                             if id(d) not in removed]
        block.sync_with_desc()
        for p in params:
            block.append_op(
                type="dist_send",
                inputs={"Param": [p], "Grad": [grads[p.name]]},
                outputs={"ParamOut": [p]},
                attrs={"param_name": p.name,
                       "blocks": [(ep, int(b), int(s))
                                  for ep, b, s in assign[p.name]]},
                infer_shape=False)

        # the rewritten program ships to a whole cluster: verify its
        # structure now, so a transpiler bug fails here with the op's
        # and var's identity, not on some remote trainer
        analysis.verify_program(program, level="structural") \
            .publish(origin="transpiler").raise_on_error()
        return self

    def init_pservers(self, scope=None):
        """Push each parameter's blocks and optimizer config to their
        pservers (the first trainer wins server-side), then pull the
        canonical values, so all trainers start identical; they go back
        into `scope` (default: the global scope) on the device and in
        the dtype the scope held."""
        scope = scope if scope is not None else global_scope()
        for pname, blocks in self.param_blocks.items():
            kind, lr_name, hp = self.param_opt[pname]
            lr_val = scope.get(lr_name)
            lr = float(torch.as_tensor(lr_val).reshape(-1)[0]) \
                if lr_val is not None else 0.01
            value = scope.get(pname)
            flat = value.detach().to(torch.float32).reshape(-1).cpu() \
                .numpy()
            for ep, begin, size in blocks:
                ClientPool.get(ep).init_param(
                    block_name(pname, begin), flat[begin:begin + size],
                    opt_kind=kind, lr=lr, hp1=hp[0], hp2=hp[1], hp3=hp[2])
            out = np.empty(flat.size, np.float32)
            for ep, begin, size in blocks:
                out[begin:begin + size] = ClientPool.get(ep).get_param(
                    block_name(pname, begin), size)
            scope.set(pname, torch.from_numpy(out).reshape(value.shape)
                      .to(value.device, value.dtype))

    def release(self):
        """Close this process's pserver connections."""
        ClientPool.reset()


def run_pserver(endpoint="127.0.0.1:6174", trainers=1, sync=True,
                async_lagged_threshold=0):
    """Start a pserver on `endpoint`'s port (0: a free one) and return
    it (reference: the pserver startup path of recv_op/ListenAndServ and
    paddle_pserver2 main).  sync=False serves the async-SGD path;
    async_lagged_threshold > 0 discards gradients computed against
    parameters at least that many versions old (reference:
    ParameterServer2.h:243).  The caller stops it (`stop()`)."""
    _host, port = endpoint.rsplit(":", 1)
    return native.ParameterServer(
        port=int(port), num_trainers=trainers, sync=sync,
        async_lagged_threshold=async_lagged_threshold)
