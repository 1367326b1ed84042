"""Lint rules over the Program IR.

Counterpart of paddle_tpu/analysis/lints.py.  Where the verifier asks
"is this program well-formed?" and the dataflow pass asks "does it
race?", the lints ask "will it be slow or silently nondeterministic?".
The codes, severities, locations and suppression keys equal the JAX
lints' for the same desc; the messages say what a finding means for
the port, which runs every op eagerly.

  L001 dynamic-dim-mxu   a dynamic (-1) dim feeds a matrix-product op
                 (the JAX side's MXU family: conv, mul, matmul,
                 flash_attention).  Each distinct size is a new shape
                 for the product's kernels (cuBLAS and cuDNN pick an
                 algorithm per shape, and a CUDA graph is captured per
                 shape).  A dynamic leading dim (the batch) is advisory
                 when shape bucketing covers it (serving bucket hints,
                 DataFeeder buckets); a dynamic inner dim is a warning.
  L002 segment-split     a host op (registered `jittable=False`: it
                 reads values on the host or has an effect) sits
                 between two runs of device ops: the device drains at
                 its seam while the host reads, and the JAX package
                 splits its executable there.
  L003 rng-no-seed       an op draws from the random stream with no seed
                 plumbing anywhere: seed attr 0, fix_seed unset, and
                 program.random_seed 0.  Replicated builds (data-
                 parallel replicas) all draw the same default stream.
  L004 amp-dtype-mix     bf16/f32 mixes that violate the AMP policy
                 (fluid/amp.py): an op reading both bfloat16 and
                 float32 dense float tensors (the implicit upcast
                 defeats the bandwidth win), or a persistable var
                 declared bfloat16 (master weights and statistics stay
                 f32).
  L005 grad-orphan       a `@GRAD`-suffixed var that is declared but
                 neither produced nor consumed (a partial backward left
                 debris), or a produced parameter grad no op consumes
                 (the update the optimizer never applied).
"""

from ..core.types import GRAD_SUFFIX
from ..ops import registry as op_registry
from .common import EMPTY, find_var_desc as _find_vd, resolve_op_info
from .diagnostics import Diagnostic, Report, Severity

__all__ = ["lint_program"]


def _mxu_types():
    # the roofline's matrix-product family (fluid/analysis.py) plus the
    # fused attention op
    from ..fluid.analysis import _MXU_FWD

    return set(_MXU_FWD) | {"flash_attention"}


def _op_jittable(od):
    info = resolve_op_info(od.type)
    # unknown: the verifier already flagged V001
    return info.jittable if info is not None else True


def _op_uses_rng(od):
    if not op_registry.has_op(od.type):
        return False  # grad kernels replay saved state, not the stream
    return op_registry.get_op_info(od.type).uses_rng


def _lint_block(desc, block_idx, report, mxu, random_seed,
                bucketed_feeds):
    bd = desc.block(block_idx)

    for i, od in enumerate(bd.ops):
        where = dict(block_idx=block_idx, op_index=i, op_type=od.type)

        fwd = od.type
        if op_registry.is_grad_op_type(fwd):
            fwd = op_registry.forward_type_of_grad(fwd)
        if fwd in mxu:
            for slot, names in od.inputs.items():
                for n in names:
                    if n == EMPTY:
                        continue
                    vd = _find_vd(desc, block_idx, n)
                    shape = tuple(vd.shape or ()) if vd else ()
                    dyn = [d for d, s in enumerate(shape)
                           if s is not None and s < 0]
                    if not dyn:
                        continue
                    inner = [d for d in dyn if d != 0]
                    if inner:
                        report.add(Diagnostic(
                            "L001", Severity.WARNING,
                            "dynamic inner dim(s) %s of input %r feed "
                            "a matrix-product op: every concrete size "
                            "is a new shape for its kernels (shape %s)"
                            % (inner, n, shape), var_name=n, **where))
                    else:
                        report.add(Diagnostic(
                            "L001", Severity.INFO,
                            "dynamic batch dim of input %r feeds a "
                            "matrix-product op%s" % (
                                n, "; shape bucketing covers it"
                                if bucketed_feeds else
                                " — without shape buckets every batch "
                                "size is a new shape for its kernels"),
                            var_name=n, **where))

        if _op_uses_rng(od) and random_seed == 0:
            attrs = od.attrs
            # initializer idiom (uniform/gaussian writing persistable
            # params in a startup program) is exempt: the scope's
            # random stream, seeded per program, makes it reproducible
            outs = [n for n in od.output_names() if n != EMPTY]

            def _persist(n):
                vd = _find_vd(desc, block_idx, n)
                return vd is not None and vd.persistable

            all_persist = bool(outs) and all(_persist(n) for n in outs)
            if not all_persist and not attrs.get("fix_seed") and \
                    not int(attrs.get("seed", 0) or 0):
                report.add(Diagnostic(
                    "L003", Severity.WARNING,
                    "op draws from the RNG stream with no seed "
                    "plumbing (seed attr 0, program.random_seed 0): "
                    "replicated builds will correlate", **where))

        floats = {}
        for slot, names in od.inputs.items():
            for n in names:
                if n == EMPTY:
                    continue
                vd = _find_vd(desc, block_idx, n)
                if vd is None or vd.dtype is None:
                    continue
                if vd.dtype in ("bfloat16", "float32"):
                    floats.setdefault(vd.dtype, n)
        if len(floats) > 1:
            report.add(Diagnostic(
                "L004", Severity.WARNING,
                "mixed bf16/f32 inputs (%s is bfloat16, %s is "
                "float32): the implicit upcast defeats the AMP "
                "bandwidth win — cast explicitly or keep the chain "
                "one dtype" % (floats["bfloat16"], floats["float32"]),
                var_name=floats["bfloat16"], **where))

    # segment splits (root-relevant in every block)
    runs = []
    for i, od in enumerate(bd.ops):
        j = _op_jittable(od)
        if runs and runs[-1][0] == j:
            runs[-1][1].append(i)
        else:
            runs.append((j, [i]))
    for k, (jit_ok, idxs) in enumerate(runs):
        if jit_ok or k == 0 or k == len(runs) - 1:
            continue
        types = sorted({bd.ops[i].type for i in idxs})
        report.add(Diagnostic(
            "L002", Severity.WARNING,
            "host op(s) %s split two runs of device ops: the block "
            "runs as %d device segments instead of 1, the device "
            "draining at each seam while the host reads"
            % (", ".join(types), sum(1 for r in runs if r[0])),
            block_idx=block_idx, op_index=idxs[0],
            op_type=bd.ops[idxs[0]].type))

    # persistable bf16 masters
    for name, vd in bd.vars.items():
        if vd.persistable and vd.dtype == "bfloat16":
            report.add(Diagnostic(
                "L004", Severity.WARNING,
                "persistable var is declared bfloat16: the AMP policy "
                "keeps master weights/statistics f32 (bf16 has 8 "
                "mantissa bits — accumulation error compounds)",
                block_idx=block_idx, var_name=name))

    # grad orphans
    produced, consumed = set(), set()
    for od in bd.ops:
        produced.update(n for n in od.output_names() if n != EMPTY)
        consumed.update(n for n in od.input_names() if n != EMPTY)
    for name, vd in bd.vars.items():
        base = name.split("@RENAME@")[0]
        if not base.endswith(GRAD_SUFFIX):
            continue
        if name not in produced and name not in consumed:
            report.add(Diagnostic(
                "L005", Severity.WARNING,
                "grad var is declared but never produced or consumed "
                "(debris from a partial backward?)",
                block_idx=block_idx, var_name=name))
            continue
        src = base[: -len(GRAD_SUFFIX)]
        svd = _find_vd(desc, block_idx, src)
        if svd is not None and svd.is_parameter and \
                name in produced and name not in consumed:
            report.add(Diagnostic(
                "L005", Severity.WARNING,
                "parameter grad %r is computed but no op consumes it "
                "— the update is never applied" % name,
                block_idx=block_idx, var_name=name))


def lint_program(desc, bucket_hints=None, suppress=(), report=None):
    """Lints over a Program or ProgramDesc; returns a `Report`.

    `bucket_hints`: the serving export's bucket dict (or anything
    truthy meaning "feeds are shape-bucketed") — demotes the
    dynamic-batch-dim finding to a covered advisory.
    """
    program = desc if hasattr(desc, "desc") else None
    desc = getattr(desc, "desc", desc)
    report = report if report is not None else Report(suppress=suppress)
    mxu = _mxu_types()
    # a bare ProgramDesc (loaded JSON) does not carry random_seed;
    # None means "unknowable" and L003 stays quiet: firing on a
    # possibly-seeded program would be a false finding
    random_seed = (program.random_seed if program is not None else None)
    bucketed = bool(bucket_hints)
    for block_idx in range(len(desc.blocks)):
        _lint_block(desc, block_idx, report, mxu, random_seed, bucketed)
    return report
