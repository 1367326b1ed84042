"""The parameter-server round trip: `dist_send`.

Counterpart of paddle_tpu/ops/dist.py (reference: send_op.cc:35, a
client shipping grads; recv_op.cc:86, the server applying the optimizer
and serving the parameters back).  `dist_send` is one round trip: ship
the grad's blocks to their parameter servers over the native framed-TCP
clients (native.py), wait until the (sync-mode) update applies, and
write the fresh parameter back.  The DistributeTranspiler appends one
per parameter after the backward (distributed/transpiler.py).

- Dense: the grad goes to the host once, as f32, each block to its
  server; the blocks the servers return make the parameter, which goes
  back to its device once, in its dtype.
- SelectedRows: the rows (int32, the wire's type) and their values go
  to the table's one server as the grad holds them, one row per id in
  order, unsummed: the server applies a repeated row once per
  occurrence (native/pserver.cc, kSendSparseGrad).  The distinct rows
  come back and one `index_copy` writes them into the table, out of
  place; the JAX op copies the whole table to the host and back
  instead.  The rows index as that op's numpy assignment does: a
  negative id counts from the end (where an id and its wrapped twin both
  occur, the non-negative one's row is written, as numpy writes it
  last), and one outside [-height, height) raises IndexError after the
  server applied the others.

While torch.profiler records, the op's stages run in ranges named
`dist_send/copy_out`, `dist_send/round_trip` and `dist_send/write_back`.
"""

import numpy as np
import torch

from .. import native
from ..core.ragged import SelectedRows
from .registry import keep_declared, register_op, span

__all__ = ["ClientPool", "dist_send", "block_name"]


def block_name(pname, begin):
    """The server-side name of parameter `pname`'s block at `begin`."""
    return "%s@%d" % (pname, begin)


class ClientPool:
    """One native connection per endpoint per process."""

    _clients = {}

    @classmethod
    def get(cls, endpoint):
        c = cls._clients.get(endpoint)
        if c is None:
            host, port = endpoint.rsplit(":", 1)
            c = native.PServerClient(host, int(port))
            cls._clients[endpoint] = c
        return c

    @classmethod
    def reset(cls):
        """Close every connection (a dead server's included)."""
        for c in cls._clients.values():
            c.close()
        cls._clients.clear()


def _send_rows(param, grad, pname, endpoint):
    c = ClientPool.get(endpoint)
    name = block_name(pname, 0)
    with span("dist_send/copy_out"):
        rows = grad.rows.cpu().numpy()
        vals = grad.values.detach().to(torch.float32).reshape(
            rows.shape[0], -1).cpu().numpy()
    with span("dist_send/round_trip"):
        c.send_sparse_grad(name, rows, vals)
        uniq = np.unique(rows)
        got = c.get_rows(name, uniq, vals.shape[1])
    with span("dist_send/write_back"):
        height = param.shape[0]
        bad = (uniq < -height) | (uniq >= height)
        if bad.any():
            raise IndexError("dist_send(%s): index %d is out of bounds for "
                             "axis 0 with size %d"
                             % (pname, uniq[bad][0], height))
        wrapped = np.where(uniq < 0, uniq + height, uniq)
        keep = (uniq >= 0) | ~np.isin(wrapped, uniq)
        index = torch.from_numpy(wrapped[keep].astype(np.int64)).to(
            param.device)
        src = torch.from_numpy(got[keep]).reshape(
            (-1,) + tuple(param.shape[1:])).to(param.device, param.dtype)
        return param.index_copy(0, index, src)


def _send_dense(param, grad, pname, blocks):
    numel = param.numel()
    covered = 0
    for _ep, begin, size in sorted(blocks, key=lambda b: b[1]):
        if begin != covered:
            break
        covered += size
    if covered != numel:
        raise ValueError("dist_send(%s): blocks %s do not tile the %d "
                         "values of the parameter" % (pname, blocks, numel))
    with span("dist_send/copy_out"):
        g = grad.detach().to(torch.float32).reshape(-1).cpu().numpy()
    out = np.empty(numel, np.float32)
    with span("dist_send/round_trip"):
        for ep, begin, size in blocks:
            out[begin:begin + size] = ClientPool.get(ep).send_grad(
                block_name(pname, begin), g[begin:begin + size])
    with span("dist_send/write_back"):
        return torch.from_numpy(out).reshape(param.shape).to(param.device,
                                                            param.dtype)


@register_op("dist_send", jittable=False, stop_gradient_op=True,
             in_place_outputs=("ParamOut",), infer_desc=keep_declared)
def dist_send(ctx, ins, attrs):
    """ParamOut: Param after its server applied Grad.  `blocks` is
    [(endpoint, begin, size)] over the flattened parameter; a
    SelectedRows grad's table lives whole on its first endpoint."""
    param = ins["Param"][0]
    grad = ins["Grad"][0]
    pname = attrs["param_name"]
    blocks = [tuple(b) for b in attrs["blocks"]]
    if isinstance(grad, SelectedRows):
        new = _send_rows(param, grad, pname, blocks[0][0])
    else:
        new = _send_dense(param, grad, pname, blocks)
    return {"ParamOut": [new]}
