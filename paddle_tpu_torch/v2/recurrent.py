"""v2 recurrent layer groups + beam-search sequence generation.

reference surface: trainer_config_helpers/layers.py recurrent_group:4082,
memory:3590, beam_search:4406, StaticInput:4051, GeneratedInput:4215,
get_output_layer, maxid_layer, eos_layer; the runtime they configure is
RecurrentGradientMachine (paddle/gserver/gradientmachines/
RecurrentGradientMachine.h:32,307-309 — per-timestep dynamic expansion
and generateSequence/beamSearch).

The port's counterpart of paddle_tpu/v2/recurrent.py:
  * recurrent_group builds the user's step function once into a
    DynamicRNN sub-block, run by the port's `recurrent` op (masked
    memory carries), not expanded per time step.  SubsequenceInput
    (nested, lod-level-2) inputs flatten the outer level into the batch
    through `seq_unnest`, `seq_outer_expand` and `seq_renest`.
  * beam_search builds the same step into a generation sub-block;
    `run_beam_search` runs it once per generated token over a dense
    [batch * beam] state on the caller's place.  The top-k over
    [batch, beam * vocab], the parents' gathers and the backtrack stay
    on the device; each step reads the host once, to learn whether
    every beam has ended.  (The fast dense decoder over a step program
    is models/decode.py; this path keeps the ragged attention inputs.)
"""

import contextlib

import torch

from ..fluid import framework
from ..fluid import layers as fl
from ..fluid.param_attr import ParamAttr
from ..core.ragged import RaggedTensor

__all__ = [
    "StaticInput", "SubsequenceInput", "GeneratedInput", "memory",
    "recurrent_group", "beam_search", "get_output_layer", "eos_layer",
    "maxid_layer", "register_layer_output",
]


# ---------------------------------------------------------------------------
# named layer outputs (v2 layers link memories by layer NAME)
# ---------------------------------------------------------------------------

def _named_layers(program=None):
    if program is None:
        program = framework.default_main_program()
    if not hasattr(program, "_v2_named_layers"):
        program._v2_named_layers = {}
    return program._v2_named_layers


def register_layer_output(name, var):
    """Record `var` as the output of the v2 layer called `name` (the
    reference links memory() to layers through these names)."""
    if name:
        _named_layers()[name] = var
    return var


def get_layer(name):
    return _named_layers().get(name)


# ---------------------------------------------------------------------------
# input markers
# ---------------------------------------------------------------------------

class StaticInput:
    """Imported unchanged into every time step (reference: layers.py
    StaticInput:4051)."""

    def __init__(self, input, is_seq=False, size=None):
        self.input = input
        self.is_seq = is_seq or getattr(input, "lod_level", 0) > 0
        self.size = size


class _SubseqInput:
    def __init__(self, input):
        self.input = input


def SubsequenceInput(input):
    """Scatter a nested (lod_level 2) sequence by outer sequence
    (reference: layers.py SubsequenceInput:4067)."""
    return _SubseqInput(input)


class BaseGeneratedInput:
    def __init__(self):
        self.bos_id = None
        self.eos_id = None


class GeneratedInput(BaseGeneratedInput):
    """The previously generated word fed back through an embedding
    (reference: layers.py GeneratedInput:4215)."""

    def __init__(self, size, embedding_name, embedding_size):
        BaseGeneratedInput.__init__(self)
        self.size = size
        self.embedding_name = embedding_name
        self.embedding_size = embedding_size


# ---------------------------------------------------------------------------
# memory()
# ---------------------------------------------------------------------------

_cur_group = None


@contextlib.contextmanager
def _activate(group):
    global _cur_group
    prev = _cur_group
    _cur_group = group
    try:
        yield
    finally:
        _cur_group = prev


def memory(name, size, memory_name=None, is_seq=False, boot_layer=None,
           boot_bias=None, boot_bias_active_type=None,
           boot_with_const_id=None):
    """The named layer's output at the previous time step (reference:
    layers.py memory:3590).  Must be called inside a recurrent_group /
    beam_search step function."""
    if _cur_group is None:
        raise RuntimeError(
            "memory() must be called inside a recurrent_group or "
            "beam_search step function")
    return _cur_group.add_memory(
        name or memory_name, size, boot_layer=boot_layer,
        boot_with_const_id=boot_with_const_id)


class _RecurrentGroup:
    """Training-path group: memories become DynamicRNN memories."""

    def __init__(self, drnn):
        self.drnn = drnn
        self._links = []       # (mem_var, layer_name)

    def add_memory(self, name, size, boot_layer=None,
                   boot_with_const_id=None):
        if boot_with_const_id is not None:
            raise NotImplementedError(
                "boot_with_const_id only applies to generation "
                "(beam_search)")
        if boot_layer is not None:
            mem = self.drnn.memory(init=boot_layer)
        else:
            if not self.drnn.seq_inputs:
                raise ValueError(
                    "memory(size=...) without boot_layer needs at least "
                    "one sequence input declared before it")
            batch_ref = self.drnn.seq_inputs[0][1]
            mem = self.drnn.memory(shape=[size], batch_ref=batch_ref,
                                   value=0.0)
        if name:
            self._links.append((mem, name))
        mem.set_input = lambda layer, _m=mem: self.link(_m, layer)
        mem._v2_memory_name = name
        return mem

    def link(self, mem, layer):
        self._links = [(m, n) for m, n in self._links if m is not mem]
        self.drnn.update_memory(mem, layer)

    def finalize(self):
        for mem, name in self._links:
            target = get_layer(name)
            if target is None:
                raise ValueError(
                    "memory(name=%r) was never linked: no layer output "
                    "registered under that name inside the step "
                    "(pass name=%r to the producing layer)" % (name, name))
            self.drnn.update_memory(mem, target)


class _NestedGroup:
    """Group for the flattened nested-sequence path: every inner
    sequence runs as an independent batch element, so there is no
    cross-subsequence recurrence to carry."""

    def add_memory(self, name, size, boot_layer=None,
                   boot_with_const_id=None):
        raise NotImplementedError(
            "memory() across subsequences is not supported by the "
            "flattened SubsequenceInput lowering; encode each "
            "subsequence here, then run an ordinary recurrent_group "
            "over the returned sentence-level sequence for the outer "
            "recurrence")

    def finalize(self):
        pass


def _nested_recurrent_group(step, inputs, name):
    """SubsequenceInput lowering (reference nested-sequence mode:
    RecurrentGradientMachine.h:32): unnest lod-2 inputs into a lod-1
    batch of inner sequences, trace `step` ONCE over that batch (inner
    recurrent_groups ride the normal lod-1 DynamicRNN), and reattach the
    outer row_splits to every output — dense per-subsequence rows
    become a sentence-level sequence, sequence outputs become nested
    again."""
    from ..fluid.layer_helper import LayerHelper

    helper = LayerHelper(name or "nested_recurrent_group")
    inners, outer_ref = {}, None
    for idx, i in enumerate(inputs):
        if not isinstance(i, _SubseqInput):
            continue
        x = i.input
        if getattr(x, "lod_level", 0) < 2:
            raise ValueError(
                "SubsequenceInput needs a nested (lod_level 2) "
                "sequence; got lod_level %d" % getattr(x, "lod_level", 0))
        inner = helper.create_tmp_variable(x.dtype, lod_level=1)
        oref = helper.create_tmp_variable("float32", lod_level=1)
        helper.append_op(type="seq_unnest", inputs={"X": [x]},
                         outputs={"Inner": [inner], "OuterRef": [oref]})
        inners[idx] = inner
        if outer_ref is None:
            outer_ref = oref

    args = []
    for idx, i in enumerate(inputs):
        if isinstance(i, _SubseqInput):
            args.append(inners[idx])
        elif isinstance(i, StaticInput):
            if i.is_seq:
                raise NotImplementedError(
                    "StaticInput(is_seq=True) inside a nested group")
            exp = helper.create_tmp_variable(i.input.dtype)
            helper.append_op(type="seq_outer_expand",
                             inputs={"X": [i.input],
                                     "OuterRef": [outer_ref]},
                             outputs={"Out": [exp]})
            args.append(exp)
        else:
            raise ValueError(
                "nested recurrent_group inputs must be SubsequenceInput "
                "or StaticInput (got %r)" % (i,))

    with _activate(_NestedGroup()):
        outs = step(*args)
    outs_list = list(outs) if isinstance(outs, (list, tuple)) else [outs]

    results = []
    for o in outs_list:
        lod = 2 if getattr(o, "lod_level", 0) else 1
        out = helper.create_tmp_variable(o.dtype, lod_level=lod)
        helper.append_op(type="seq_renest",
                         inputs={"X": [o], "OuterRef": [outer_ref]},
                         outputs={"Out": [out]})
        results.append(out)
    return results[0] if len(results) == 1 else results


def recurrent_group(step, input, reverse=False, name=None,
                    targetInlink=None):
    """Iterate `step` over the time steps of the sequence inputs
    (reference: layers.py recurrent_group:4082 over
    RecurrentGradientMachine).  Built as one DynamicRNN; StaticInput
    vars enter its step block's closure unchanged.
    With SubsequenceInput (nested lod-2) inputs the group flattens the
    outer level into the batch instead (see _nested_recurrent_group);
    `reverse` is identity there since the flattened form has no
    cross-subsequence order dependence."""
    inputs = list(input) if isinstance(input, (list, tuple)) else [input]
    if any(isinstance(i, _SubseqInput) for i in inputs):
        return _nested_recurrent_group(step, inputs, name)

    # reverse inlinks before the loop; outputs un-reversed after
    prepared = []
    for i in inputs:
        if isinstance(i, StaticInput):
            prepared.append(i)
        elif isinstance(i, framework.Variable):
            prepared.append(fl.sequence_reverse(i) if reverse else i)
        else:
            raise ValueError("recurrent_group inputs must be sequence "
                             "Variables or StaticInput (got %r)" % (i,))

    drnn = fl.DynamicRNN(name=name)
    group = _RecurrentGroup(drnn)
    with drnn.block():
        args = []
        for i in prepared:
            if isinstance(i, StaticInput):
                args.append(i.input)
            else:
                args.append(drnn.step_input(i))
        with _activate(group):
            outs = step(*args)
        outs_list = list(outs) if isinstance(outs, (list, tuple)) \
            else [outs]
        group.finalize()
        drnn.output(*outs_list)
    result = drnn()
    result = result if isinstance(result, list) else [result]
    if reverse:
        result = [fl.sequence_reverse(r) for r in result]
    return result[0] if len(result) == 1 else result


# ---------------------------------------------------------------------------
# misc layers of the recurrent surface
# ---------------------------------------------------------------------------

def get_output_layer(input, arg_name, name=None, **kw):
    """Extract a non-default output of a layer, e.g. the lstm step's
    cell state (reference: layers.py get_output_layer)."""
    extra = getattr(input, "_v2_extra_outputs", None)
    if not extra or arg_name not in extra:
        raise ValueError("layer has no extra output %r" % arg_name)
    return register_layer_output(name, extra[arg_name])


def maxid_layer(input, name=None, **kw):
    _, idx = fl.topk(input=input, k=1)
    return register_layer_output(name, idx)


def eos_layer(input, eos_id, name=None, **kw):
    """1.0 where the id equals eos_id (reference: layers.py
    eos_layer:4366)."""
    eos = fl.fill_constant(shape=[1], dtype=input.dtype,
                           value=float(eos_id))
    return register_layer_output(name, fl.equal(x=input, y=eos))


# ---------------------------------------------------------------------------
# beam_search generation
# ---------------------------------------------------------------------------

class _GenGroup:
    """Generation-path group: memories become decode-loop state fed into
    the traced step block each iteration."""

    def __init__(self, block):
        self.block = block
        self.mems = []         # dicts: var, name, size, boot (outer var
        #                        name or None), const_id, new (var name)
        self._links = []

    def add_memory(self, name, size, boot_layer=None,
                   boot_with_const_id=None):
        dtype = "int64" if boot_with_const_id is not None else "float32"
        var = self.block.create_var(
            name=framework.unique_name("@".join(["gen_mem", name or "m"])),
            dtype=dtype,
            shape=(-1, 1) if boot_with_const_id is not None
            else (-1, size))
        rec = {"var": var, "name": name, "size": size,
               "boot": boot_layer.name if boot_layer is not None else None,
               "const_id": boot_with_const_id, "new": None}
        self.mems.append(rec)
        if name:
            self._links.append((rec, name))
        var.set_input = lambda layer, _r=rec: _r.update(
            {"new": layer.name})
        return var

    def finalize(self):
        for rec, name in self._links:
            if rec["new"] is not None:
                continue
            target = get_layer(name)
            if target is not None:
                rec["new"] = target.name
        for rec in self.mems:
            if rec["const_id"] is None and rec["new"] is None:
                raise ValueError(
                    "generation memory %r never updated: register a "
                    "layer output under its name or call set_input()"
                    % (rec["name"] or rec["var"].name))


class _BeamGenSpec:
    def __init__(self, program, block_idx, prev_ids_name, probs_name,
                 mems, statics, bos_id, eos_id, beam_size, max_length,
                 num_results_per_sample):
        self.program = program
        self.block_idx = block_idx
        self.prev_ids_name = prev_ids_name
        self.probs_name = probs_name
        self.mems = mems             # list of dicts (see _GenGroup)
        self.statics = statics       # [(sub var name == outer name?, ...)]
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.beam_size = beam_size
        self.max_length = max_length
        self.num_results_per_sample = num_results_per_sample


def beam_search(step, input, bos_id, eos_id, beam_size, max_length=500,
                name=None, num_results_per_sample=None):
    """Configure beam-search generation over `step` (reference: layers.py
    beam_search:4406 over RecurrentGradientMachine::beamSearch).

    Returns a handle Variable; run it with paddle.infer(
    output_layer=handle, field=['prob', 'id']) — 'prob' is a
    [batch, num_results] score array, 'id' the flat id stream with each
    result as bos ... eos -1 (the reference's output format)."""
    if num_results_per_sample is None:
        num_results_per_sample = beam_size
    num_results_per_sample = min(num_results_per_sample, beam_size)

    inputs = list(input) if isinstance(input, (list, tuple)) else [input]
    gen = None
    for i in inputs:
        if isinstance(i, BaseGeneratedInput):
            if gen is not None:
                raise ValueError("beam_search accepts exactly one "
                                 "GeneratedInput")
            gen = i
    if gen is None:
        raise ValueError("beam_search needs a GeneratedInput")
    gen.bos_id, gen.eos_id = bos_id, eos_id

    prog = framework.default_main_program()
    parent = prog.current_block()
    sub = prog.create_block()
    try:
        group = _GenGroup(sub)
        prev_ids = group.add_memory("__beam_search_predict__", gen.size,
                                    boot_with_const_id=bos_id)

        statics = []
        args = []
        for i in inputs:
            if isinstance(i, BaseGeneratedInput):
                emb = fl.embedding(
                    input=prev_ids,
                    size=[gen.size, gen.embedding_size],
                    param_attr=ParamAttr(name=gen.embedding_name))
                args.append(emb)
            elif isinstance(i, StaticInput):
                statics.append(i.input.name)
                args.append(i.input)
            else:
                raise ValueError(
                    "beam_search inputs must be StaticInput or "
                    "GeneratedInput (got %r)" % (i,))

        with _activate(group):
            outs = step(*args)
        outs_list = list(outs) if isinstance(outs, (list, tuple)) \
            else [outs]
        group.finalize()
        probs = outs_list[0]
    finally:
        prog.rollback()

    handle = parent.create_var(
        name=framework.unique_name("beam_gen"), dtype="int64")
    handle._v2_beam_spec = _BeamGenSpec(
        prog, sub.idx, prev_ids.name, probs.name,
        [m for m in group.mems if m["const_id"] is None],
        statics, bos_id, eos_id, beam_size, max_length,
        num_results_per_sample)
    return handle


# ---------------------------------------------------------------------------
# the generation loop (RecurrentGradientMachine::beamSearch analog)
# ---------------------------------------------------------------------------

def _ragged_repeat(rt, k):
    """Each sequence of the lod-1 `rt` repeated k times consecutively
    (the beam expansion of a ragged static input), by one gather on its
    device: the result has k times the rows, those past its `nvalid`
    copies of a valid row."""
    splits = rt.last_splits().long()
    lengths = splits[1:] - splits[:-1]
    new_splits = torch.zeros(lengths.shape[0] * k + 1, dtype=torch.long,
                             device=splits.device)
    new_splits[1:] = torch.cumsum(lengths.repeat_interleave(k), 0)
    rows = torch.arange(rt.values.shape[0] * k, device=splits.device)
    seq = (torch.searchsorted(new_splits, rows, right=True) - 1).clamp(
        0, new_splits.shape[0] - 2)
    src = splits[seq // k] + (rows - new_splits[seq])
    src = src.clamp(0, max(rt.values.shape[0] - 1, 0))
    return RaggedTensor(rt.values[src], [new_splits], new_splits[-1],
                        max_seqlen=rt.max_seqlen)


def _is_persistable(program, block_idx, name):
    bd = program.desc.block(block_idx)
    while True:
        if name in bd.vars:
            return bool(bd.vars[name].persistable)
        if bd.parent_idx < 0:
            return False
        bd = program.desc.block(bd.parent_idx)


def _step_params(spec, scope, place):
    """{name: value} of the persistables the generation step reads.  One
    that no run gave a value yet (a parameter only the generation
    topology declares, made after the training startup ran) comes from
    a run of the startup program on `place` into a throwaway scope, so
    trained weights are never overwritten, and is set in `scope`."""
    from ..core.scope import Scope
    from ..fluid.executor import Executor

    block_desc = spec.program.desc.block(spec.block_idx)
    needed = sorted({n for od in block_desc.ops for n in od.input_names()
                     if _is_persistable(spec.program, spec.block_idx, n)})
    env = {n: scope.get(n) for n in needed if scope.get(n) is not None}
    missing = [n for n in needed if n not in env]
    if missing:
        tmp = Scope()
        Executor(place).run(framework.default_startup_program(), scope=tmp)
        for n in missing:
            v = tmp.get(n)
            if v is None:
                raise KeyError(
                    "generation step needs %r but it is neither in the "
                    "scope nor produced by the startup program" % n)
            scope.set(n, v)
            env[n] = v
    return env


def run_beam_search(spec, boot_values, static_values, batch_size, place,
                    scope=None, rng_seed=0, stats=None):
    """Run the decode loop on `place`.  boot_values: {mem name: [B, size]
    tensor}, static_values: {outer var name: tensor or RaggedTensor}.
    Returns (scores [B, num_results] ndarray, the id stream: a list of
    ints, each result bos ... eos then -1), as the JAX package's
    `run_beam_search` does; beams tied in score may come in another
    order.  `stats`, a dict, receives the steps run ("steps")."""
    from ..core.scope import global_scope
    from ..fluid.executor import ExecContext
    from ..ops.registry import values_of

    device = place.device()
    scope = scope or global_scope()
    B, K = batch_size, spec.beam_size
    N = B * K
    NEG = -1e30

    mems = {}
    for m in spec.mems:
        if m["boot"] is not None:
            boot = values_of(boot_values[m["var"].name]).to(device)
        else:
            boot = torch.zeros((B, m["size"]), dtype=torch.float32,
                               device=device)
        mems[m["var"].name] = boot.repeat_interleave(K, 0)
    env0 = _step_params(spec, scope, place)
    for name in spec.statics:
        v = static_values[name]
        env0[name] = (_ragged_repeat(v.to(device), K)
                      if isinstance(v, RaggedTensor)
                      else values_of(v).to(device).repeat_interleave(K, 0))

    prev = torch.full((N, 1), spec.bos_id, dtype=torch.int32, device=device)
    first = torch.full((K,), NEG, dtype=torch.float32, device=device)
    first[0] = 0.0
    scores = first.repeat(B)
    done = torch.zeros(N, dtype=torch.bool, device=device)
    rows = torch.arange(B, device=device)[:, None] * K
    gen = torch.Generator(device=device).manual_seed(rng_seed)
    tok_hist, parent_hist = [], []
    eos_only = None
    for _ in range(spec.max_length):
        env = dict(env0)
        env.update(mems)
        env[spec.prev_ids_name] = prev
        ExecContext(spec.program.desc, spec.block_idx, env, place=place,
                    device=device, rng=gen).run_block(spec.block_idx, env)
        probs = values_of(env[spec.probs_name]).reshape(N, -1).float()
        V = probs.shape[1]
        if eos_only is None:
            eos_only = torch.full((V,), NEG, dtype=torch.float32,
                                  device=device)
            eos_only[spec.eos_id] = 0.0
        logp = torch.log(probs.clamp(min=1e-30))
        logp = torch.where(done[:, None], eos_only[None, :], logp)
        total = (scores[:, None] + logp).reshape(B, K * V)
        top_scores, top_idx = torch.topk(total, K, dim=1)
        beam_idx = top_idx // V
        tok_idx = top_idx % V
        flat_src = (rows + beam_idx).reshape(-1)
        for m in spec.mems:
            new = values_of(env[m["new"]]).reshape(N, -1)
            mems[m["var"].name] = new[flat_src]
        prev = tok_idx.reshape(N, 1).to(torch.int32)
        scores = top_scores.reshape(-1)
        done = done[flat_src] | (prev.reshape(-1) == spec.eos_id)
        tok_hist.append(tok_idx)
        parent_hist.append(beam_idx)
        if bool(done.all()):      # the one host read of a step
            break

    if stats is not None:
        stats["steps"] = len(tok_hist)

    # backtrack the parents (reference: beam_search_decode PackAllSteps)
    beams = torch.arange(K, device=device).expand(B, K)
    rev = []
    for tok, par in zip(reversed(tok_hist), reversed(parent_hist)):
        rev.append(torch.gather(tok, 1, beams))
        beams = torch.gather(par, 1, beams)
    seqs = torch.stack(rev[::-1], 2)                      # [B, K, T]
    final = scores.reshape(B, K)
    order = torch.argsort(-final, dim=1, stable=True)
    final = torch.gather(final, 1, order)
    seqs = torch.gather(seqs, 1, order[:, :, None].expand(-1, -1,
                                                          seqs.shape[2]))

    R = spec.num_results_per_sample
    final, seqs = final[:, :R].cpu().numpy(), seqs.cpu().numpy()
    id_stream = []
    for b in range(B):
        for r in range(R):
            ids = [spec.bos_id]
            for w in seqs[b, r].tolist():
                ids.append(int(w))
                if w == spec.eos_id:
                    break
            if ids[-1] != spec.eos_id:
                ids.append(spec.eos_id)
            id_stream.extend(ids)
            id_stream.append(-1)
    return final, id_stream
