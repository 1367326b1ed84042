"""The program builder: Variable, Parameter, Operator, Block, Program.

Counterpart of paddle_tpu/fluid/framework.py (reference:
python/paddle/v2/fluid/framework.py — Variable:125, Operator:350,
Block:621, Program:789).  The descs of core/desc.py are the IR; these
classes are views over them that the layers build through.  Names come
from per-program counters (`unique_name`), so every fresh Program gives
the same names, the JAX package's: a program built here equals the JAX
package's through `to_dict()`.

Shape inference on `append_op` runs the op's kernel on meta tensors
(`ops.registry.infer_meta`): it sets each output VarDesc's shape,
dtype, lod level and type (SELECTED_ROWS where the op gives a
SelectedRows), with -1 wherever a dynamic input dim reaches the
output.  An op whose output shapes follow from descs rather than from
running it (`recurrent`, which reads its step block's VarDescs) sets
them through its `infer_desc` rule instead.

Sub-blocks: `Program.create_block()` appends a block whose parent is
the current block and makes it current until `rollback()`
(`block_guard()` does both); the layers build into the current block,
and parameters always go to block 0.  An op in a sub-block reads the
vars of its parents: shape inference looks names up through the parent
chain (`_find_var_desc`), as does `Block.var_recursive`.
"""

import contextlib
import copy

from ..core.desc import OpDesc, ProgramDesc, VarDesc
from ..core.types import GRAD_SUFFIX, VarType, canonical_dtype
from .. import ops as _ops  # noqa: F401  (registers every kernel)
from ..ops import registry as op_registry

__all__ = [
    "Variable", "Parameter", "Operator", "Block", "Program",
    "default_main_program", "default_startup_program", "program_guard",
    "switch_main_program", "switch_startup_program", "unique_name",
    "InferShapeError",
]


def unique_name(prefix, program=None):
    """`prefix_N` for the next N of `prefix` in `program` (default: the
    current main program).  Counters are per program, as on the JAX
    side: every fresh Program yields the same names."""
    counters = (program or default_main_program())._name_counters
    idx = counters.get(prefix, 0)
    counters[prefix] = idx + 1
    return "%s_%d" % (prefix, idx)


class Variable:
    """A symbolic variable of a Block (reference: framework.py:125); its
    VarDesc is created on first sight, updated when found again."""

    def __init__(self, block, name=None, shape=None, dtype=None,
                 lod_level=None, persistable=None, stop_gradient=False,
                 type=VarType.DENSE_TENSOR, **kwargs):
        self.block = block
        if name is None:
            name = unique_name("_generated_var")
        desc = block.desc.vars.get(name)
        if desc is None:
            desc = VarDesc(
                name, type=type,
                dtype=dtype if dtype is not None else "float32",
                shape=shape if shape is not None else (),
                lod_level=lod_level or 0, persistable=bool(persistable),
                stop_gradient=stop_gradient)
            block.desc.vars[name] = desc
        else:
            if shape is not None:
                desc.shape = tuple(int(s) for s in shape)
            if dtype is not None:
                desc.dtype = canonical_dtype(dtype)
            if lod_level is not None:
                desc.lod_level = lod_level
            if persistable is not None:
                desc.persistable = bool(persistable)
        self.desc = desc

    @property
    def name(self):
        return self.desc.name

    @property
    def shape(self):
        return tuple(self.desc.shape)

    @property
    def dtype(self):
        return self.desc.dtype

    @property
    def lod_level(self):
        return self.desc.lod_level

    @property
    def type(self):
        """The VarType: SELECTED_ROWS for a sparse grad."""
        return self.desc.type

    @property
    def persistable(self):
        return self.desc.persistable

    @persistable.setter
    def persistable(self, p):
        self.desc.persistable = bool(p)

    @property
    def stop_gradient(self):
        return self.desc.stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, s):
        self.desc.stop_gradient = bool(s)

    def __repr__(self):
        return "Variable(%s)" % (self.desc,)


class Parameter(Variable):
    """A trainable persistable variable (reference: framework.py
    Parameter): its shape is static; `regularizer` is its own weight
    decay (fluid/regularizer.py), None for the optimizer's."""

    def __init__(self, block, shape, dtype, trainable=True,
                 optimize_attr=None, regularizer=None, **kwargs):
        if shape is None or dtype is None:
            raise ValueError("Parameter needs shape and dtype")
        if any(d < 0 for d in shape):
            raise ValueError("Parameter shape must be static: %s"
                             % (shape,))
        kwargs.setdefault("persistable", True)
        Variable.__init__(self, block, shape=shape, dtype=dtype, **kwargs)
        self.desc.is_parameter = True
        self.trainable = trainable
        self.optimize_attr = optimize_attr or {"learning_rate": 1.0}
        self.regularizer = regularizer


class Operator:
    """A view over an OpDesc (reference: framework.py:350)."""

    def __init__(self, block, desc):
        self.block = block
        self.desc = desc

    @property
    def type(self):
        return self.desc.type

    def input(self, slot):
        return self.desc.input(slot)

    def output(self, slot):
        return self.desc.output(slot)

    def attr(self, name, default=None):
        return self.desc.attr(name, default)

    @property
    def attrs(self):
        return self.desc.attrs

    def __repr__(self):
        return repr(self.desc)


def _var_names(v):
    if isinstance(v, (list, tuple)):
        return [x.name if isinstance(x, Variable) else str(x) for x in v]
    return [v.name if isinstance(v, Variable) else str(v)]


class Block:
    """reference: framework.py:621."""

    def __init__(self, program, desc):
        self.program = program
        self.desc = desc
        self.vars = {}      # name -> Variable
        self.ops = []       # Operator views

    @property
    def idx(self):
        return self.desc.idx

    @property
    def parent_idx(self):
        return self.desc.parent_idx

    @property
    def parent_block(self):
        """The enclosing Block, None for block 0."""
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    def create_var(self, *args, **kwargs):
        v = Variable(self, *args, **kwargs)
        self.vars[v.name] = v
        return v

    def create_parameter(self, *args, **kwargs):
        gb = self.program.global_block()
        p = Parameter(gb, *args, **kwargs)
        gb.vars[p.name] = p
        return p

    def has_var(self, name):
        return name in self.desc.vars

    def has_var_recursive(self, name):
        """Whether this block or one of its parents declares `name`."""
        b = self
        while b is not None:
            if b.has_var(name):
                return True
            b = b.parent_block
        return False

    def var(self, name):
        """The Variable `name` of this block; ValueError if absent."""
        if name in self.vars:
            return self.vars[name]
        if name in self.desc.vars:
            v = Variable(self, name=name)
            self.vars[name] = v
            return v
        raise ValueError("var %r not in block %d" % (name, self.idx))

    def var_recursive(self, name):
        """The Variable `name` of this block or of the nearest parent
        that declares it; ValueError if none does."""
        b = self
        while b is not None:
            if b.has_var(name):
                return b.var(name)
            b = b.parent_block
        raise ValueError("var %r not found from block %d"
                         % (name, self.idx))

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type=None, inputs=None, outputs=None, attrs=None,
                  infer_shape=True):
        """inputs/outputs: {slot: Variable | [Variable] | name | [name]};
        the outputs' VarDescs take the inferred shapes and dtypes."""
        op_desc = OpDesc(
            type,
            {k: _var_names(v) for k, v in (inputs or {}).items()
             if v is not None},
            {k: _var_names(v) for k, v in (outputs or {}).items()
             if v is not None},
            attrs or {})
        op = Operator(self, op_desc)
        self.desc.ops.append(op_desc)
        self.ops.append(op)
        if infer_shape:
            infer_shape_for_op(self, op_desc)
        return op

    def sync_with_desc(self):
        """Rebuild the Operator views, and views of new vars, after the
        desc was edited directly (the backward appends to it)."""
        self.ops = [Operator(self, od) for od in self.desc.ops]
        for name, vd in self.desc.vars.items():
            if name not in self.vars:
                self.vars[name] = Variable(self, name=name)


class Program:
    """reference: framework.py:789.  `Program.from_desc` wraps a desc
    built elsewhere (shared, not copied).  `random_seed` seeds the
    random stream of the scope it first runs in (fluid/executor.py)."""

    def __init__(self):
        self.desc = ProgramDesc()
        self.blocks = [Block(self, self.desc.block(0))]
        self.current_block_idx = 0
        self.random_seed = 0
        # names scope to the program (see unique_name)
        self._name_counters = {}

    @classmethod
    def from_desc(cls, desc):
        """A Program over `desc`, whose VarDescs marked `is_parameter`
        become Parameters; building on it appends to `desc`."""
        p = cls.__new__(cls)
        p.desc = desc
        p.current_block_idx = 0
        p.random_seed = 0
        p._name_counters = {}
        p.blocks = [Block(p, bd) for bd in desc.blocks]
        for b in p.blocks:
            for name, vd in b.desc.vars.items():
                if vd.is_parameter:
                    param = Parameter.__new__(Parameter)
                    param.block, param.desc = b, vd
                    param.trainable = True
                    param.optimize_attr = {"learning_rate": 1.0}
                    param.regularizer = None
                    b.vars[name] = param
            b.sync_with_desc()
        return p

    def global_block(self):
        return self.blocks[0]

    def block(self, idx):
        return self.blocks[idx]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def create_block(self, parent_idx=None):
        """Append a block whose parent is `parent_idx` (default: the
        current block) and make it the current block."""
        parent = self.current_block_idx if parent_idx is None \
            else parent_idx
        b = Block(self, self.desc.append_block(parent))
        self.blocks.append(b)
        self.current_block_idx = b.idx
        return b

    def rollback(self):
        """Make the current block's parent current again."""
        self.current_block_idx = self.current_block().parent_idx

    @contextlib.contextmanager
    def block_guard(self, parent_idx=None):
        b = self.create_block(parent_idx)
        try:
            yield b
        finally:
            self.rollback()

    def list_vars(self):
        """Every Variable of every block, in desc order."""
        for b in self.blocks:
            for name in b.desc.vars:
                yield b.var(name)

    def clone(self, for_test=False):
        """A deep copy of the descs (reference: Program.clone), which the
        layers may go on building on; `for_test` sets `is_test` on every
        op that has the attr (batch_norm, dropout)."""
        p = Program.from_desc(ProgramDesc.from_dict(
            copy.deepcopy(self.desc.to_dict())))
        p._name_counters = dict(self._name_counters)
        p.random_seed = self.random_seed
        for name, var in self.global_block().vars.items():
            if isinstance(var, Parameter) and name in p.global_block().vars:
                pv = p.global_block().vars[name]
                pv.trainable = var.trainable
                pv.optimize_attr = var.optimize_attr
                pv.regularizer = var.regularizer
        if for_test:
            for b in p.desc.blocks:
                for op in b.ops:
                    if "is_test" in op.attrs:
                        op.attrs["is_test"] = True
        return p

    def to_string(self):
        return "\n".join(
            "Block[%d] parent=%d\n%s" % (b.idx, b.parent_idx, "\n".join(
                ["  %r" % v for v in b.desc.vars.values()]
                + ["  %r" % o for o in b.desc.ops]))
            for b in self.blocks)

    __repr__ = to_string


class InferShapeError(ValueError):
    """Shape inference failed for one op: its type, its index in the
    block and the variable at fault where known."""

    def __init__(self, message, op_type=None, op_index=None,
                 var_name=None):
        super().__init__(message)
        self.op_type = op_type
        self.op_index = op_index
        self.var_name = var_name


def infer_shape_for_op(block, op_desc):
    """Set the output VarDescs' shape and dtype: a grad op's outputs
    mirror their forward vars; any other op runs on meta tensors.
    Failures raise InferShapeError naming the op."""
    try:
        if op_registry.has_op(op_desc.type):
            rule = op_registry.get_op_info(op_desc.type).infer_desc
            if rule is not None:
                rule(block, op_desc)
                return
        if op_registry.is_grad_op_type(op_desc.type) \
                and not op_registry.has_op(op_desc.type):
            _grad_op_infer_shape(block, op_desc)
            return
        ins_meta = {}
        for slot, names in op_desc.inputs.items():
            metas = []
            for n in names:
                vd = _find_var_desc(block, n)
                metas.append((vd.shape, vd.dtype, vd.lod_level, vd.type))
            ins_meta[slot] = metas
        outs = op_registry.infer_meta(op_desc.type, ins_meta, op_desc.attrs)
    except KeyError as err:
        raise _infer_error(block, op_desc, err,
                           getattr(err, "var_name", None)) from err
    except (TypeError, ValueError, RuntimeError, IndexError) as err:
        raise _infer_error(block, op_desc, err) from err
    for slot, names in op_desc.outputs.items():
        for n, meta in zip(names, outs.get(slot) or ()):
            if meta is None:
                continue
            vd = _find_var_desc(block, n)
            vd.shape, vd.dtype = meta[0], canonical_dtype(meta[1])
            vd.lod_level = meta[2]
            vd.type = meta[3] if len(meta) > 3 else VarType.DENSE_TENSOR


def _infer_error(block, op_desc, err, var_name=None):
    idx = next((i for i, od in enumerate(block.desc.ops) if od is op_desc),
               None)
    where = "op %r (op %s in block %d)" % (op_desc.type, idx, block.idx)
    if var_name is not None:
        where += ", var %r" % var_name
    return InferShapeError("shape inference failed for %s: %s: %s"
                           % (where, type(err).__name__, err),
                           op_type=op_desc.type, op_index=idx,
                           var_name=var_name)


def _find_var_desc(block, name):
    """The VarDesc `name` of `block` or of the nearest parent declaring
    it; a KeyError (carrying `var_name`) if none does."""
    bd = block.desc
    while True:
        if name in bd.vars:
            return bd.vars[name]
        if bd.parent_idx < 0:
            err = KeyError("var desc %r not found from block %d"
                           % (name, block.idx))
            err.var_name = name
            raise err
        bd = block.program.desc.block(bd.parent_idx)


def _find_var_desc_or_none(block, name):
    try:
        return _find_var_desc(block, name)
    except KeyError:
        return None


def _grad_op_infer_shape(block, op_desc):
    """X@GRAD has the meta of X (either found through the parents)."""
    for names in op_desc.outputs.values():
        for n in names:
            if n.endswith(GRAD_SUFFIX):
                src = _find_var_desc_or_none(block, n[: -len(GRAD_SUFFIX)])
                vd = _find_var_desc_or_none(block, n)
                if src is not None and vd is not None:
                    vd.shape, vd.dtype = src.shape, src.dtype
                    vd.lod_level = src.lod_level


_main_program = Program()
_startup_program = Program()


def default_main_program():
    return _main_program


def default_startup_program():
    return _startup_program


def switch_main_program(p):
    global _main_program
    old, _main_program = _main_program, p
    return old


def switch_startup_program(p):
    global _startup_program
    old, _startup_program = _startup_program, p
    return old


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)
