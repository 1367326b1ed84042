"""Graphviz rendering of a Program (developer tooling).

Parity target: the reference's config visualizers
(python/paddle/utils/make_model_diagram.py — layers as nodes,
projections as edges — and show_pb.py / dump_config.py textual dumps).
Counterpart of paddle_tpu/utils/model_diagram.py: for one ProgramDesc
its DOT and text are the JAX module's byte for byte.  The graph IS the
ProgramDesc: ops become boxes (grad ops, which the op registry names,
dashed), tensors become edges labeled with shape/dtype, sub-blocks
(while/cond bodies) become clusters, and the same module doubles as the
textual dump (``program_to_text``).

Usage:
    python -m paddle_tpu_torch.utils.model_diagram model.json graph.dot
    # then: dot -Tpng graph.dot -o graph.png
"""

import json

__all__ = ["program_to_dot", "program_to_text"]


def _esc(s):
    return str(s).replace('"', r'\"')


def _var_label(block, name):
    try:
        v = block.var(name)
    except KeyError:
        return name
    shape = "x".join(map(str, v.shape)) if v.shape else "scalar"
    return "%s\\n%s %s" % (name, v.dtype or "?", shape)


def program_to_dot(program, max_label=40):
    """Render every block: ops as boxes (grad ops dashed, optimizer
    ops doubled), parameters as gray ellipses, data edges labeled by
    dtype/shape.  Accepts a fluid Program or a bare ProgramDesc."""
    from ..ops import registry as op_registry

    desc = getattr(program, "desc", program)
    out = ["digraph program {", "  rankdir=TB;",
           '  node [fontsize=10, shape=box];']
    for block in desc.blocks:
        indent = "  "
        if block.idx != 0:
            out.append("  subgraph cluster_block%d {" % block.idx)
            out.append('    label="block %d (parent %d)";'
                       % (block.idx, block.parent_idx))
            indent = "    "
        for v in block.vars.values():
            if v.persistable:
                out.append(
                    '%s"%s" [shape=ellipse, style=filled, '
                    'fillcolor=lightgray, label="%s"];'
                    % (indent, _esc(v.name),
                       _esc(_var_label(block, v.name))))
        for i, op in enumerate(block.ops):
            style = ""
            if op_registry.is_grad_op_type(op.type):
                style = ", style=dashed"
            elif op.type in ("sgd", "momentum", "adam", "adagrad",
                             "rmsprop", "fused_update"):
                style = ", peripheries=2"
            node = "b%d_op%d" % (block.idx, i)
            out.append('%s"%s" [label="%s"%s];'
                       % (indent, node, _esc(op.type), style))
            # parameters draw as source nodes; intermediate tensors
            # render as edge labels instead (the useful diagram is
            # op->op dataflow, not a bipartite var/op graph)
            for name in op.input_names():
                if block.has_var(name) and block.var(name).persistable:
                    out.append('%s"%s" -> "%s";'
                               % (indent, _esc(name), node))
            for j in range(i + 1, len(block.ops)):
                later = block.ops[j]
                produced = set(op.output_names())
                consumed = produced & set(later.input_names())
                if consumed:
                    label = _esc(_var_label(
                        block, sorted(consumed)[0])[:max_label])
                    out.append(
                        '%s"%s" -> "b%d_op%d" [label="%s", '
                        'fontsize=8];' % (indent, node, block.idx, j,
                                          label))
        if block.idx != 0:
            out.append("  }")
    out.append("}")
    return "\n".join(out)


def program_to_text(program):
    """dump_config/show_pb-style flat listing, one op per line."""
    desc = getattr(program, "desc", program)
    lines = []
    for block in desc.blocks:
        lines.append("block %d (parent %d):"
                     % (block.idx, block.parent_idx))
        for v in block.vars.values():
            lines.append("  var  %r" % (v,))
        for op in block.ops:
            lines.append("  op   %r" % (op,))
    return "\n".join(lines)


def main(argv=None):
    import sys

    from ..core.desc import ProgramDesc

    argv = argv if argv is not None else sys.argv[1:]
    if not 1 <= len(argv) <= 2:
        raise SystemExit(
            "usage: python -m paddle_tpu_torch.utils.model_diagram "
            "<model.json|__model__> [out.dot]")
    with open(argv[0]) as f:
        data = json.load(f)
    desc = ProgramDesc.from_dict(data.get("program", data))
    dot = program_to_dot(desc)
    if len(argv) == 2:
        with open(argv[1], "w") as f:
            f.write(dot)
    else:
        print(dot)


if __name__ == "__main__":
    main()
