"""Roofline analysis over the Program IR.

Counterpart of paddle_tpu/fluid/analysis.py.  Computes, per op, the
arithmetic work (FLOPs) and the memory traffic (bytes moved) implied by
the VarDesc shapes, and the resulting time floor on a device with a
given peak rate and memory bandwidth:

    t_op >= max(flops / peak_flops, bytes / bandwidth)

A profile of a step says where the time went; this says where it has
to go, so the gap between the two is the headroom.  The defaults are
the card's (`utils/device_peaks.py`): 989 TFLOP/s, the bf16 tensor
cores, and 3,350 GB/s.  The port runs f32 products with TF32 off, on
the f32 cores, so a caller that prices an f32 program passes
`peak_tflops=67` (`device_peaks.F32_CORE_FLOPS`).

Model caveats (as on the JAX side):
  * bytes are per op (every input read and every output written once).
    The port runs each op as its own kernels, so the per-op sum is the
    traffic it pays; the unique-bytes bound, where each distinct tensor
    moves once, is what perfect fusion would pay.  Both are reported.
  * `tpu_tiling=True` counts physical bytes under the TPU's memory
    tiling (the minor dim padded to 128 lanes, the second-minor to
    8/16/32 sublanes by element size), the JAX package's byte model
    behind the `layout` pass's decision (compile/opt_passes.py).  It is
    kept as that pass's gate; the card has no such tiling.
  * with `bf16_act` (the amp_bf16_act policy), non-persistable float
    tensors count 2 bytes an element; persistables stay 4.
  * grad ops of the matrix-product families count 2x the forward
    FLOPs (the input grad and the weight grad are each a product of
    the forward's size).

The program may be a Program or a ProgramDesc.
"""

from collections import defaultdict

from ..analysis.common import find_var_desc
from ..ops import registry as op_registry
from ..utils.device_peaks import BF16_FLOPS, HBM_BYTES_PER_S

__all__ = ["op_cost", "program_costs", "roofline_report", "format_report",
           "DEFAULT_PEAK_TFLOPS", "DEFAULT_HBM_GBPS"]

# the card's figures
DEFAULT_PEAK_TFLOPS = BF16_FLOPS / 1e12
DEFAULT_HBM_GBPS = HBM_BYTES_PER_S / 1e9

# the op types whose work is a matrix product (the JAX side's MXU family)
_MXU_FWD = {"conv2d", "conv3d", "conv2d_transpose", "conv3d_transpose",
            "depthwise_conv2d", "mul", "matmul"}


def _desc_of(program):
    return getattr(program, "desc", program)


def _block_desc(program, block):
    """The BlockDesc priced: `block` (a Block or a BlockDesc), else block
    0 of `program`."""
    if block is None:
        return _desc_of(program).block(0)
    return getattr(block, "desc", block)


def _numel(shape):
    if shape is None:
        return 0
    n = 1
    for s in shape:
        n *= max(int(s), 1)  # -1 (dynamic) counted as 1: callers price
    return n                 # static-shape programs for real numbers


def _var_meta(desc, block_idx, name):
    """(shape, dtype name) of `name` seen from block `block_idx`, or
    None for a placeholder or an undeclared name."""
    if not name or name.startswith("@"):
        return None
    vd = find_var_desc(desc, block_idx, name)
    if vd is None:
        return None
    return vd.shape, str(vd.dtype)


def _elem_bytes(dtype, persistable, bf16_act):
    size = {"float64": 8, "int64": 8, "float32": 4, "int32": 4,
            "float16": 2, "bfloat16": 2, "uint8": 1, "int8": 1,
            "bool": 1}.get(dtype, 4)
    if bf16_act and size == 4 and dtype.startswith("float") \
            and not persistable:
        return 2
    return size


def _ceil_to(n, mult):
    return (n + mult - 1) // mult * mult


def _numel_tiled(shape, esize):
    """Physical element count under the TPU's memory tiling: the minor
    dim pads to 128 lanes, the second-minor to the dtype's sublane
    count (f32 8, bf16 16, int8 32).  Rank-0 and rank-1 tensors occupy
    whole tiles of the minor dim."""
    sublane = {4: 8, 2: 16, 1: 32}.get(esize, 8)
    if shape is None:
        return 0
    dims = [max(int(s), 1) for s in shape]  # -1 (dynamic) counted as 1
    if not dims:
        return sublane * 128
    if len(dims) == 1:
        return _ceil_to(dims[0], 128) * sublane
    n = 1
    for s in dims[:-2]:
        n *= s
    return n * _ceil_to(dims[-2], sublane) * _ceil_to(dims[-1], 128)


def _conv_flops(desc, block_idx, od, fwd_type):
    """2 * out_spatial * N * K * C/g * prod(kernel).  The output shape
    is the forward's Output; for a grad op its O@Output operand."""
    out_name = (od.output("Output") or [None])[0] \
        if od.type == fwd_type else (od.input("O@Output") or [None])[0]
    w_name = (od.input("Filter") or [None])[0]
    out = _var_meta(desc, block_idx, out_name)
    w = _var_meta(desc, block_idx, w_name)
    if not out or not w or out[0] is None or w[0] is None:
        return 0
    groups = int(od.attr("groups", 1) or 1)
    n_out = _numel(out[0])
    # filter shape [K, C/g, *kernel] (transpose convs store [C, K/g, *])
    per_out = 2 * _numel(w[0]) // max(int(w[0][0]), 1)
    return n_out * per_out // max(groups, 1) * \
        (1 if od.type == fwd_type else 2)


def _mul_flops(desc, block_idx, od, fwd_type):
    out_name = (od.output("Out") or [None])[0] \
        if od.type == fwd_type else (od.input("O@Out") or [None])[0]
    x = _var_meta(desc, block_idx, (od.input("X") or [None])[0])
    y = _var_meta(desc, block_idx, (od.input("Y") or [None])[0])
    out = _var_meta(desc, block_idx, out_name)
    if not x or not y or not out or None in (x[0], y[0], out[0]):
        return 0
    k = _numel(y[0]) // max(int(y[0][-1]), 1)  # contracted extent
    flops = 2 * _numel(out[0]) * k
    return flops * (1 if od.type == fwd_type else 2)


def _tensor_bytes(desc, block_idx, name, bf16_act, tiled=False):
    meta = _var_meta(desc, block_idx, name)
    if not meta or meta[0] is None:
        return 0
    vd = find_var_desc(desc, block_idx, name)
    esize = _elem_bytes(meta[1], bool(vd.persistable), bf16_act)
    numel = _numel_tiled(meta[0], esize) if tiled else _numel(meta[0])
    return numel * esize


def op_cost(desc, block_idx, od, bf16_act=False, tiled=False):
    """(flops, bytes, klass) of OpDesc `od` of block `block_idx` of
    ProgramDesc `desc`; klass is "mxu" for a matrix product, else
    "hbm" (the JAX side's names)."""
    fwd = od.type
    if op_registry.is_grad_op_type(od.type):
        fwd = op_registry.forward_type_of_grad(od.type)
    flops = 0
    if fwd in _MXU_FWD:
        if fwd.startswith("conv") or fwd == "depthwise_conv2d":
            flops = _conv_flops(desc, block_idx, od, fwd)
        else:
            flops = _mul_flops(desc, block_idx, od, fwd)
        klass = "mxu"
    else:
        klass = "hbm"
    total_bytes = 0
    for names in list(od.inputs.values()) + list(od.outputs.values()):
        for n in names:
            total_bytes += _tensor_bytes(desc, block_idx, n, bf16_act,
                                         tiled=tiled)
    return flops, total_bytes, klass


def program_costs(program, bf16_act=False, block=None, tiled=False):
    """Per-op cost rows of block 0 (or `block`):
    [(op_type, flops, bytes, klass), ...] in op order."""
    desc = _desc_of(program)
    bd = _block_desc(program, block)
    return [(od.type,) + op_cost(desc, bd.idx, od, bf16_act, tiled=tiled)
            for od in bd.ops]


def _unique_bytes(desc, bd, bf16_act, tiled=False):
    """Bytes if every referenced tensor moved exactly once: the traffic
    floor of perfect fusion."""
    seen = set()
    total = 0
    for od in bd.ops:
        for names in list(od.inputs.values()) + list(od.outputs.values()):
            for n in names:
                if n not in seen:
                    seen.add(n)
                    total += _tensor_bytes(desc, bd.idx, n, bf16_act,
                                           tiled=tiled)
    return total


def roofline_report(program, peak_tflops=DEFAULT_PEAK_TFLOPS,
                    hbm_gbps=DEFAULT_HBM_GBPS, bf16_act=False,
                    block=None, tpu_tiling=False):
    """Aggregate time floors.  Returns a dict with per-op-type rows and
    two step floors:
      * `floor_ms_serial`: the sum over ops of max(t_flops, t_bytes),
        every op alone, no fusion (the port's eager execution);
      * `floor_ms_ideal`: max(total FLOPs / peak, unique bytes / bw),
        perfect fusion and perfect compute/memory overlap.
    A measured step lands above both; its distance from
    `floor_ms_serial` is what launches and host time cost, and the
    distance between the floors is what fusion could save."""
    desc = _desc_of(program)
    bd = _block_desc(program, block)
    rows = program_costs(desc, bf16_act=bf16_act, block=bd,
                         tiled=tpu_tiling)
    peak = peak_tflops * 1e12
    bw = hbm_gbps * 1e9
    agg = defaultdict(lambda: [0, 0, 0, 0.0])  # count, flops, bytes, t
    t_serial = 0.0
    tot_flops = 0
    tot_bytes = 0
    for op_type, flops, nbytes, _ in rows:
        t = max(flops / peak, nbytes / bw)
        a = agg[op_type]
        a[0] += 1
        a[1] += flops
        a[2] += nbytes
        a[3] += t
        t_serial += t
        tot_flops += flops
        tot_bytes += nbytes
    uniq = _unique_bytes(desc, bd, bf16_act, tiled=tpu_tiling)
    return {
        "per_type": {k: {"count": v[0], "gflops": v[1] / 1e9,
                         "mbytes": v[2] / 1e6, "t_ms": v[3] * 1e3}
                     for k, v in agg.items()},
        "total_gflops": tot_flops / 1e9,
        "total_gbytes": tot_bytes / 1e9,
        "unique_gbytes": uniq / 1e9,
        "floor_ms_serial": t_serial * 1e3,
        "floor_ms_ideal": max(tot_flops / peak, uniq / bw) * 1e3,
        "peak_tflops": peak_tflops,
        "hbm_gbps": hbm_gbps,
        "bf16_act": bf16_act,
        "tpu_tiling": bool(tpu_tiling),
    }


def format_report(report, topk=12):
    lines = ["%-28s %6s %12s %12s %10s" % (
        "op type", "count", "GFLOP", "MB moved", "t floor ms")]
    per = sorted(report["per_type"].items(),
                 key=lambda kv: -kv[1]["t_ms"])
    for k, v in per[:topk]:
        lines.append("%-28s %6d %12.2f %12.1f %10.3f" % (
            k, v["count"], v["gflops"], v["mbytes"], v["t_ms"]))
    if len(per) > topk:
        rest = per[topk:]
        lines.append("%-28s %6d %12.2f %12.1f %10.3f" % (
            "(%d more types)" % len(rest),
            sum(v["count"] for _, v in rest),
            sum(v["gflops"] for _, v in rest),
            sum(v["mbytes"] for _, v in rest),
            sum(v["t_ms"] for _, v in rest)))
    lines.append("")
    lines.append("total %.1f GFLOP, %.2f GB per-op / %.2f GB unique  "
                 "(peak %.0f TFLOP/s, %.0f GB/s, bf16_act=%s)"
                 % (report["total_gflops"], report["total_gbytes"],
                    report["unique_gbytes"], report["peak_tflops"],
                    report["hbm_gbps"], report["bf16_act"]))
    lines.append("step floor: %.2f ms serial-per-op  |  %.2f ms "
                 "perfectly-fused" % (report["floor_ms_serial"],
                                      report["floor_ms_ideal"]))
    return "\n".join(lines)
