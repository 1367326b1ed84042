"""Single-file model packaging for deployment.

Parity target: the reference's ``paddle.utils.merge_model``
(python/paddle/utils/merge_model.py:25-73), which concatenates a
size-framed model proto with the raw parameter buffers for the C-API.
Counterpart of paddle_tpu/utils/merge_model.py, with the same format:
the deployable artifact is one uncompressed tar, an ``__model__`` member
(the pruned inference ProgramDesc JSON with feed/fetch names, the
save_inference_model format) plus one self-describing ``<param>.npz``
member per persistable — the same members a save_inference_model
directory holds, so a merged file and a directory are interchangeable
at load time, and a file merged by either package loads in the other
(bfloat16 values as their bits in a V2 array, as both packages save
them).  ``load_merged_model`` puts each value on the executor's place.
"""

import io
import json
import os
import tarfile

__all__ = ["merge_v2_model", "merge_inference_model",
           "load_merged_model"]


def _add_member(tar, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


def merge_inference_model(dirname, output_file,
                          model_filename="__model__"):
    """Pack a ``save_inference_model`` directory into one file."""
    with tarfile.open(output_file, "w") as tar:
        for fname in sorted(os.listdir(dirname)):
            with open(os.path.join(dirname, fname), "rb") as f:
                _add_member(tar, fname, f.read())
    return output_file


def merge_v2_model(net, param_file, output_file):
    """Merge a v2 inference topology (its output layer) and a
    ``Parameters.to_tar`` file into one deployable file.

    Matches the reference entry point's signature: ``net`` is the
    output layer of the network built under the default program,
    ``param_file`` the trained-parameters tar, ``output_file`` the
    merged artifact.
    """
    import numpy as np

    from ..fluid import framework
    from ..fluid import io as fluid_io

    outputs = list(net) if isinstance(net, (list, tuple)) else [net]
    program = fluid_io.prune_program(framework.default_main_program(),
                                     outputs)
    block = program.global_block()
    produced = {n for op in block.desc.ops for n in op.output_names()}
    feed_names = sorted(
        n for op in block.desc.ops for ns in op.inputs.values()
        for n in ns
        if n not in produced and block.desc.has_var(n)
        and not block.desc.var(n).persistable)
    meta = {
        "program": program.desc.to_dict(),
        "feed_names": feed_names,
        "fetch_names": [o.name for o in outputs],
    }
    with open(param_file, "rb") as f:
        src = tarfile.open(fileobj=io.BytesIO(f.read()))
    with tarfile.open(output_file, "w") as tar:
        _add_member(tar, "__model__", json.dumps(meta).encode())
        for member in src.getmembers():
            if not member.name.endswith(".npy"):
                continue
            name = member.name[:-4]
            if not block.desc.has_var(name):
                continue  # pruned away with its consumers
            arr = np.load(io.BytesIO(src.extractfile(member).read()))
            buf = io.BytesIO()
            # the save_vars npz framing (fluid/io.py _save_one), so
            # _load_one decodes merged members and directory files alike
            np.savez(buf, __ragged__=0, values=arr)
            _add_member(tar, name.replace("/", "_") + ".npz",
                        buf.getvalue())
    return output_file


def load_merged_model(path, executor, scope=None,
                      model_filename="__model__"):
    """Load a merged file: returns (program, feed_names, fetch_vars),
    the JAX package's ``load_inference_model`` contract, with the
    parameters placed in the scope as tensors on the executor's place
    (the CPU without an executor)."""
    from ..core.desc import ProgramDesc
    from ..core.scope import global_scope
    from ..fluid import framework
    from ..fluid import io as fluid_io

    scope = scope if scope is not None else global_scope()
    device = executor.device if executor is not None else "cpu"
    with tarfile.open(path) as tar:
        meta = json.loads(tar.extractfile(model_filename).read())
        program = framework.Program.from_desc(
            ProgramDesc.from_dict(meta["program"]))
        members = {m.name for m in tar.getmembers()}
        for var in program.list_vars():
            member = var.name.replace("/", "_") + ".npz"
            if not var.persistable or member not in members:
                continue
            value = fluid_io._load_one(
                None, var.name, fileobj=io.BytesIO(
                    tar.extractfile(member).read()))
            scope.set_local(var.name, value.to(device))
    fetch_vars = [program.global_block().var(n)
                  for n in meta["fetch_names"]]
    return program, meta["feed_names"], fetch_vars
