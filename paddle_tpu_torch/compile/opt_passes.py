"""Cost-model-guided optimization passes: layout, fuse, auto_remat.

Counterpart of paddle_tpu/compile/opt_passes.py.  Each is a
Program -> Program rewrite run by the PassManager (compile/passes.py),
verified around it and folding its knobs into the pipeline id:

  layout      NCHW->NHWC for conv, pool and batch-norm chains through
              `fluid.data_transform.convert_layout` (one transpose per
              var per layout boundary).  Accepted only when the
              roofline's tiled byte model (fluid/analysis.py
              `tpu_tiling=True`: the minor dim padded to 128 lanes, the
              second-minor to the dtype's sublanes) predicts a strictly
              lower ideal floor for the converted program.  That is the
              JAX package's gate, kept as it is; it reads the roofline's
              defaults, which are the card's figures in the port, so it
              can decide otherwise than the JAX gate for the same
              program.  `layout:force=1` skips the gate.  Forward
              programs only: a training program declines with a note
              (convert the forward before append_backward:
              `fluid.convert_layout`).
  fuse        greedy fusion of single-consumer elementwise, activation
              and bias chains into `fused_elemwise_chain` ops
              (fluid/fusion.py): the chain's intermediates leave the IR.
              `fuse:cap=N` bounds a group's size (0 = unbounded).
              Declines without a fetch set, as dce does.
  auto_remat  activation checkpointing: when the liveness activation-peak
              estimate (`activation_peak_bytes`, the shard analyzer's
              S005 accounting) exceeds the memory budget, checkpoints
              are picked every `stride` forward ops
              (fluid/recompute.auto_checkpoints) and the backward
              region is rewritten to recompute the forward segments
              between them (fluid/recompute.recompute_program), as the
              JAX pass does.  `auto_remat:stride=N:budget_gb=G`; G <= 0
              rewrites whatever the estimate.  The executor releases
              each value after its last reader, so on the card the
              rewrite lowers a captured step's pool.
"""

from ..ops import registry as op_registry
from .passes import RewritePass, program_copy, register_pass

__all__ = ["LayoutOptimize", "ElemwiseFusion", "AutoRemat",
           "DEFAULT_REMAT_BUDGET_GB", "activation_peak_bytes"]

# auto_remat's default budget, the JAX pass's (its knob's default is
# part of the pipeline id)
DEFAULT_REMAT_BUDGET_GB = 16.0


def _has_grad_ops(desc):
    return any(op_registry.is_grad_op_type(od.type)
               for b in desc.blocks for od in b.ops)


def _bf16_act_now():
    from ..utils import flags

    return bool(flags.get_flag("amp_bf16")
                and flags.get_flag("amp_bf16_act"))


def activation_peak_bytes(desc, fetches=()):
    """Peak live non-persistable bytes over block 0 (dynamic dims count
    1, so it is a floor), by the liveness walk of
    `dataflow.liveness_peak_bytes` with the AMP activation element
    sizes."""
    from ..analysis.dataflow import liveness_peak_bytes
    from ..fluid import analysis as fluid_analysis

    bd = desc.block(0)
    bf16_act = _bf16_act_now()
    final_live = {n for n, vd in bd.vars.items() if vd.persistable}
    final_live |= set(fetches or ())

    def _act_bytes(n):
        vd = bd.vars.get(n)
        if vd is None or vd.persistable or vd.shape is None:
            return 0
        return fluid_analysis._numel(vd.shape) * \
            fluid_analysis._elem_bytes(str(vd.dtype), False, bf16_act)

    peak, _op = liveness_peak_bytes(bd.ops, _act_bytes, final_live)
    return peak


class LayoutOptimize(RewritePass):
    """NCHW->NHWC rewrite, accepted only on a predicted roofline win."""

    name = "layout"
    options = {"force": (int, 0)}  # 1 = skip the cost gate

    @staticmethod
    def _tiled_floor(program):
        from ..fluid import analysis

        rep = analysis.roofline_report(program, tpu_tiling=True,
                                       bf16_act=_bf16_act_now())
        return rep["floor_ms_ideal"]

    def run(self, desc, ctx):
        from ..fluid import data_transform

        if not ctx.fetches:
            # the dce contract: a fetch is a by-name lookup at run time
            # the IR cannot see; without the fetch set the guard below
            # cannot keep a fetched in-chain 4-D intermediate from
            # observing permuted values, so the pass declines
            ctx.note = "no fetch set; layout declines (dce contract)"
            return None
        if _has_grad_ops(desc):
            ctx.note = ("training program: layout must convert the "
                        "forward before append_backward "
                        "(fluid.convert_layout)")
            return None
        bd = desc.block(0)
        capable = [od for od in bd.ops
                   if od.type in data_transform.LAYOUT_CAPABLE]
        if not capable:
            ctx.note = "no layout-capable op (conv/pool/bn)"
            return None
        if any(od.attr("data_layout", "NCHW") == "NHWC"
               for od in capable):
            ctx.note = "program already runs NHWC"
            return None

        # a trial conversion on a scratch copy prices the decision; the
        # base floor comes from a scratch copy too, so both sides see
        # the same metadata
        base = program_copy(desc)
        trial = program_copy(desc)
        trial_layout = {}
        data_transform.convert_layout(trial, to="NHWC",
                                      layout_out=trial_layout)
        # the rewrite keeps boundary values NCHW, but a fetch of an
        # in-chain 4-D intermediate would observe the permuted layout:
        # decline rather than change an observable value.  Membership
        # in the conversion's layout map is the test (a C==H==W tensor
        # permutes to the same shape)
        for name in sorted(ctx.fetches):
            if trial_layout.get(name) == "NHWC":
                ctx.note = "fetch %r changes layout; declined" % name
                return None
        floor_nchw = self._tiled_floor(base)
        floor_nhwc = self._tiled_floor(trial)
        if not self.force and floor_nhwc >= floor_nchw:
            ctx.note = ("tiled roofline predicts no win "
                        "(NCHW %.3f ms <= NHWC %.3f ms ideal floor)"
                        % (floor_nchw, floor_nhwc))
            return None
        n = data_transform.convert_layout(ctx.program, to="NHWC")
        diff = {"inserted_transposes": n,
                "converted_ops": len(capable),
                "floor_ms_ideal": {"nchw": round(floor_nchw, 6),
                                   "nhwc": round(floor_nhwc, 6)}}
        if self.force:
            diff["forced"] = True
        return diff


class ElemwiseFusion(RewritePass):
    """Greedy elementwise/activation/bias chain fusion (fluid/fusion)."""

    name = "fuse"
    options = {"cap": (int, 0)}  # max stages per fused op; 0 = unbounded

    def validate_options(self):
        if self.cap < 0 or self.cap == 1:
            raise ValueError("fuse:cap must be 0 (unbounded) or >= 2, "
                             "got %d" % self.cap)

    def run(self, desc, ctx):
        from ..fluid import fusion

        if not ctx.fetches:
            # the dce contract: fusing away a fetched intermediate would
            # break the fetch, and the IR cannot see fetches
            ctx.note = "no fetch set; fusion declines (dce contract)"
            return None
        fused = fusion.fuse_elemwise_chains(
            desc, block_idx=0, keep=ctx.keep_names(0), cap=self.cap)
        if not fused:
            ctx.note = "no fusable single-consumer chain"
            return None
        return {"fused_chains": fused}


class AutoRemat(RewritePass):
    """Activation checkpointing when the peak estimate exceeds the
    memory budget (fluid/recompute.py does the rewrite)."""

    name = "auto_remat"
    options = {"stride": (int, 8),
               "budget_gb": (float, DEFAULT_REMAT_BUDGET_GB)}

    def validate_options(self):
        if self.stride < 1:
            raise ValueError("auto_remat:stride must be >= 1, got %d"
                             % self.stride)

    def run(self, desc, ctx):
        from ..fluid import recompute
        from ..fluid.recompute import _RCP

        bd = desc.block(0)
        if not any(op_registry.is_grad_op_type(od.type)
                   for od in bd.ops):
            ctx.note = "no backward region to rematerialize into"
            return None
        if any(_RCP in n for n in bd.vars):
            ctx.note = "program already rematerialized"
            return None
        peak_before = activation_peak_bytes(desc, ctx.fetches)
        budget = self.budget_gb * (1 << 30)
        if self.budget_gb > 0 and peak_before <= budget:
            ctx.note = ("activation peak %.3f GiB within the %.1f GiB "
                        "budget" % (peak_before / 2**30, self.budget_gb))
            return None
        picks = recompute.auto_checkpoints(ctx.program,
                                           every=self.stride)
        if not picks:
            ctx.note = "no checkpointable forward op"
            return None
        cloned = recompute.recompute_program(ctx.program, picks)
        if not cloned:
            ctx.note = "nothing to rematerialize between checkpoints"
            return None
        peak_after = activation_peak_bytes(desc, ctx.fetches)
        return {"cloned_forward_ops": cloned,
                "checkpoints": len(picks),
                "stride": self.stride,
                "activation_peak_bytes": {"before": peak_before,
                                          "after": peak_after}}


register_pass(LayoutOptimize())
register_pass(ElemwiseFusion())
register_pass(AutoRemat())
