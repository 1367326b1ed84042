"""Structural verification of a ProgramDesc.

Counterpart of paddle_tpu/analysis/verifier.py.  The reference
validates programs piecemeal at runtime (per-op InferShape and attr
checkers); this pass checks the whole IR up front and reports
structured `Diagnostic`s:

  V001 unknown-op        op type not in the registry (nor `<fwd>_grad`
                         of a registered forward)
  V002 undeclared-var    an input/output slot names a var with no
                         VarDesc anywhere on the block's scope chain
  V003 use-before-def    an input is produced only LATER in its block
                         (and is neither persistable nor a feed)
  V004 dangling-block-ref  a BlockRef attr indexes a missing block, or
                         one whose parent chain does not pass through
                         the referencing op's block
  V005 dtype-mismatch    recorded output dtype differs from the dtype
                         re-derived through the registry's shape
                         inference
  V006 shape-mismatch    recorded static output shape differs from the
                         re-derived one (dynamic -1 dims are wildcards)
  V007 infer-shape-failure  the registry's shape inference itself
                         rejects the recorded input metas (shape/dtype
                         algebra broken, e.g. a matmul inner-dim
                         mismatch)
  V008 bad-attr          an attr value does not serialize (not a
                         scalar/str/list/BlockRef tree)

`level="structural"` runs V001-V004/V008 only (pure desc walking) —
cheap enough for every program load.  `level="full"` adds the
V005-V007 re-derivation, each op's kernel run on meta tensors
(`ops.registry.infer_meta`, where the JAX side runs `jax.eval_shape`);
an op with an `infer_desc` rule (one that sets its output descs
itself, or a host op such as `dist_send`) keeps its declared metas.
"""

import numpy as np

from ..core.desc import BlockRef
from ..core.types import GRAD_SUFFIX, VarType, canonical_dtype, exec_dtype
from ..ops import registry as op_registry
from .common import EMPTY, find_var_desc as _find_var_desc, \
    resolve_op_info
from .diagnostics import Diagnostic, Report, Severity

__all__ = ["verify_program"]

_JSONABLE_SCALARS = (bool, int, float, str, bytes, type(None))


def _known_op(op_type):
    return resolve_op_info(op_type) is not None


def _attr_ok(value):
    if isinstance(value, _JSONABLE_SCALARS) or isinstance(value, BlockRef):
        return True
    if isinstance(value, (list, tuple)):
        return all(_attr_ok(v) for v in value)
    # numpy scalars sneak into attrs from shape math; they serialize
    return isinstance(value, (np.integer, np.floating, np.bool_))


def _block_refs(op_desc):
    refs = []
    for key, v in op_desc.attrs.items():
        if isinstance(v, BlockRef):
            refs.append((key, v.idx))
        elif isinstance(v, (list, tuple)):
            refs.extend((key, x.idx) for x in v if isinstance(x, BlockRef))
    return refs


def _chain_reaches(desc, sub_idx, owner_idx):
    """Does sub-block `sub_idx`'s parent chain pass through
    `owner_idx`?  (The op holding the BlockRef lives in owner.)"""
    idx = sub_idx
    seen = set()
    while 0 <= idx < len(desc.blocks) and idx not in seen:
        if idx == owner_idx:
            return True
        seen.add(idx)
        idx = desc.block(idx).parent_idx
    return owner_idx == 0 and idx == -1  # root owns every chain end


# ---------------------------------------------------------------------------
# structural pass
# ---------------------------------------------------------------------------

def _produced_somewhere(desc):
    """Names produced by any op in any block: a producer-less
    non-persistable var is a feed candidate (the executor accepts it
    from the feed dict).  Computed ONCE per program (verify_program
    passes it down)."""
    produced = set()
    for b in desc.blocks:
        for od in b.ops:
            produced.update(n for n in od.output_names() if n != EMPTY)
    return produced


def _verify_block_structure(desc, block_idx, report,
                            produced_somewhere=None):
    bd = desc.block(block_idx)

    # first def index per name IN THIS BLOCK (ordering applies within a
    # block only; names from ancestor blocks are closures)
    first_def = {}
    for i, od in enumerate(bd.ops):
        for n in od.output_names():
            if n != EMPTY and n not in first_def:
                first_def[n] = i
    if produced_somewhere is None:
        produced_somewhere = _produced_somewhere(desc)

    for i, od in enumerate(bd.ops):
        where = dict(block_idx=block_idx, op_index=i, op_type=od.type)

        if not _known_op(od.type):
            report.add(Diagnostic(
                "V001", Severity.ERROR,
                "op type %r is not registered" % od.type, **where))
            # slot/attr checks below don't need the registry; keep going

        for key, value in od.attrs.items():
            if not _attr_ok(value):
                report.add(Diagnostic(
                    "V008", Severity.ERROR,
                    "attr %r holds a non-serializable value of type %s"
                    % (key, type(value).__name__), **where))
        for key, idx in _block_refs(od):
            if not (0 <= idx < len(desc.blocks)):
                report.add(Diagnostic(
                    "V004", Severity.ERROR,
                    "attr %r references block %d but the program has "
                    "%d block(s)" % (key, idx, len(desc.blocks)),
                    **where))
            elif idx != block_idx and not _chain_reaches(desc, idx,
                                                         block_idx):
                report.add(Diagnostic(
                    "V004", Severity.ERROR,
                    "attr %r references block %d whose parent chain "
                    "does not pass through block %d"
                    % (key, idx, block_idx), **where))

        for slot, names in od.inputs.items():
            for n in names:
                if n == EMPTY:
                    continue
                vd = _find_var_desc(desc, block_idx, n)
                if vd is None:
                    report.add(Diagnostic(
                        "V002", Severity.ERROR,
                        "input slot %r reads %r, which has no VarDesc "
                        "on the block's scope chain" % (slot, n),
                        var_name=n, **where))
                    continue
                if vd.persistable or vd.type == VarType.TENSOR_ARRAY:
                    continue  # initialized by startup / first write
                d = first_def.get(n)
                # d == i is the by-name in-place idiom (the op reads
                # the PREVIOUS value — fed or scope-resident — and
                # writes the new one, e.g. increment in_place): only a
                # strictly later first definition is an error
                if d is not None and d > i and n in bd.vars:
                    report.add(Diagnostic(
                        "V003", Severity.ERROR,
                        "input slot %r reads %r before its first "
                        "definition (op %d)" % (slot, n, d),
                        var_name=n, **where))
                elif d is None and n in bd.vars \
                        and n in produced_somewhere:
                    # produced only in OTHER blocks yet declared here:
                    # nothing in this block (or a feed) supplies it
                    report.add(Diagnostic(
                        "V003", Severity.ERROR,
                        "input slot %r reads %r, which no op in block "
                        "%d produces (and it is not persistable)"
                        % (slot, n, block_idx), var_name=n, **where))

        for slot, names in od.outputs.items():
            for n in names:
                if n == EMPTY:
                    continue
                if _find_var_desc(desc, block_idx, n) is None:
                    report.add(Diagnostic(
                        "V002", Severity.ERROR,
                        "output slot %r writes %r, which has no "
                        "VarDesc on the block's scope chain"
                        % (slot, n), var_name=n, **where))


# ---------------------------------------------------------------------------
# meta re-derivation pass (level="full")
# ---------------------------------------------------------------------------

def _shapes_conflict(recorded, computed):
    """Static dims must agree; -1 on either side is a wildcard.  An
    empty/missing recorded shape means 'never inferred' — not a
    conflict."""
    if not recorded or computed is None:
        return False
    if len(recorded) != len(computed):
        return True
    return any(r != c for r, c in zip(recorded, computed)
               if r is not None and r >= 0 and c is not None and c >= 0)


def _verify_block_meta(desc, block_idx, report):
    bd = desc.block(block_idx)
    for i, od in enumerate(bd.ops):
        where = dict(block_idx=block_idx, op_index=i, op_type=od.type)
        if not _known_op(od.type):
            continue  # already a V001
        if op_registry.is_grad_op_type(od.type) \
                and not op_registry.has_op(od.type):
            _verify_grad_meta(desc, block_idx, od, where, report)
            continue
        if op_registry.get_op_info(od.type).infer_desc is not None:
            # desc rules mutate descs (no side-effect-free
            # re-derivation); host ops keep their declared meta
            continue

        ins_meta = {}
        broken = False
        for slot, names in od.inputs.items():
            metas = []
            for n in names:
                if n == EMPTY:
                    broken = True  # generic kernels can't take holes
                    break
                vd = _find_var_desc(desc, block_idx, n)
                if vd is None or vd.shape is None:
                    broken = True  # V002 already reported / no meta
                    break
                metas.append((vd.shape, vd.dtype, vd.lod_level, vd.type))
            if broken:
                break
            ins_meta[slot] = metas
        if broken:
            continue

        try:
            outs = op_registry.infer_meta(od.type, ins_meta, od.attrs)
        except Exception as err:
            report.add(Diagnostic(
                "V007", Severity.ERROR,
                "infer-shape rejected the recorded input metas: %s: %s"
                % (type(err).__name__, err), **where))
            continue

        for slot, names in od.outputs.items():
            metas = outs.get(slot)
            if metas is None:
                continue
            for n, meta in zip(names, metas):
                if n == EMPTY:
                    continue
                vd = _find_var_desc(desc, block_idx, n)
                if vd is None:
                    continue  # V002 already reported
                shape, dtype = meta[0], meta[1]
                if vd.dtype is not None and \
                        exec_dtype(vd.dtype) != exec_dtype(dtype):
                    report.add(Diagnostic(
                        "V005", Severity.ERROR,
                        "output slot %r: recorded dtype %s, but the "
                        "registry's shape inference derives %s"
                        % (slot, vd.dtype, canonical_dtype(dtype)),
                        var_name=n, **where))
                if _shapes_conflict(vd.shape, shape):
                    report.add(Diagnostic(
                        "V006", Severity.ERROR,
                        "output slot %r: recorded shape %s, but the "
                        "registry's shape inference derives %s"
                        % (slot, tuple(vd.shape), tuple(shape)),
                        var_name=n, **where))


def _verify_grad_meta(desc, block_idx, od, where, report):
    """Generic grad ops: `X@GRAD` mirrors `X` (the backward builder's
    contract, see framework._grad_op_infer_shape)."""
    for slot, names in od.outputs.items():
        for n in names:
            if n == EMPTY or not n.endswith(GRAD_SUFFIX):
                continue
            src = n[: -len(GRAD_SUFFIX)]
            svd = _find_var_desc(desc, block_idx, src)
            gvd = _find_var_desc(desc, block_idx, n)
            if svd is None or gvd is None:
                continue
            if gvd.dtype is not None and svd.dtype is not None and \
                    exec_dtype(gvd.dtype) != exec_dtype(svd.dtype):
                report.add(Diagnostic(
                    "V005", Severity.ERROR,
                    "grad output %r has dtype %s but its source %r "
                    "has %s" % (n, gvd.dtype, src, svd.dtype),
                    var_name=n, **where))
            if _shapes_conflict(gvd.shape, svd.shape):
                report.add(Diagnostic(
                    "V006", Severity.ERROR,
                    "grad output %r has shape %s but its source %r "
                    "has %s" % (n, tuple(gvd.shape), src,
                                tuple(svd.shape)),
                    var_name=n, **where))


def verify_program(desc, level="full", suppress=(), report=None):
    """Verify a ProgramDesc (or Program); returns a `Report`.

    level: "structural" — registry/slot/scope/attr checks only;
           "full" — also re-derive output dtype/shape per op through
           the registry and compare against the recorded VarDescs.
    """
    desc = getattr(desc, "desc", desc)  # accept Program
    if level not in ("structural", "full"):
        raise ValueError("level must be 'structural' or 'full', got %r"
                         % (level,))
    report = report if report is not None else Report(suppress=suppress)
    produced = _produced_somewhere(desc)
    for block_idx in range(len(desc.blocks)):
        _verify_block_structure(desc, block_idx, report,
                                produced_somewhere=produced)
    if level == "full":
        for block_idx in range(len(desc.blocks)):
            _verify_block_meta(desc, block_idx, report)
    return report
