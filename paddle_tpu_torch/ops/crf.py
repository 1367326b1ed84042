"""Linear-chain CRF ops: `linear_chain_crf`, `crf_decoding` and
`chunk_eval`.

Counterpart of paddle_tpu/ops/crf.py (reference: linear_chain_crf_op.cc,
the forward recursion and the negative log-likelihood;
crf_decoding_op.cc, Viterbi; chunk_eval_op.cc, chunk precision, recall
and F1).

- `linear_chain_crf` pads the ragged emission to [B, Tmax, D] and runs
  the forward recursion in log space as a Python loop of `Tmax` steps,
  each step masked by the sequences' lengths, as the JAX side's
  `lax.scan` does.  Its grad is the generic vjp of that loop.
- `crf_decoding` is a batched Viterbi on the executor's device in
  float64 over the same padded batch, where the JAX side loops over the
  sequences in numpy on the host.  The same float64 additions and
  maxima give the same paths; a tie goes to the first tag, as numpy's
  `argmax` breaks it.
- `chunk_eval` counts chunks on the host, as on the JAX side (the
  reference registers it for the CPU only); its counts come back on
  the input's device.

Transition [D + 2, D] (reference linear_chain_crf_op.cc:29-33): row 0
holds the start weights, row 1 the end weights, rows 2.. the [D, D]
matrix w, w[i, j] the score of tag i followed by tag j.
"""

import numpy as np
import torch

from ..core.ragged import RaggedTensor
from .registry import register_op
from .sequence import padded_to_ragged, ragged_to_padded


def _padded_labels(label):
    """[B, Tmax] int64 tags of a ragged [T, 1] Label, 0 past each
    length."""
    if not isinstance(label, RaggedTensor):
        raise TypeError("the CRF's Label must be a sequence (ragged)")
    lp, _ = ragged_to_padded(label.with_values(
        label.values.reshape(-1, 1).to(torch.int32)))
    return lp[:, :, 0].long()


@register_op("linear_chain_crf", nondiff_inputs=("Label",))
def linear_chain_crf(ctx, ins, attrs):
    """LogLikelihood [B, 1]: each sequence's negative log-likelihood,
    log Z less the gold path's score (start weight, emissions,
    transitions, end weight).  log Z comes from alpha_0 = a + e_0 and
    alpha_t = logsumexp_i(alpha_{t-1}[i] + w[i, :]) + e_t while t is
    inside the sequence; a sequence of length 1 has alpha_0 alone.
    Alpha holds every step's alpha over the emission's rows;
    EmissionExps and TransitionExps the exponentials, as on the JAX
    side."""
    emission = ins["Emission"][0]
    transition = ins["Transition"][0]
    e_pad, lengths = ragged_to_padded(emission)
    labels = _padded_labels(ins["Label"][0])
    B, Tmax, D = e_pad.shape
    a, b, w = transition[0], transition[1], transition[2:]
    t_idx = torch.arange(Tmax, dtype=lengths.dtype, device=lengths.device)
    active = t_idx[None, :] < lengths[:, None]

    alpha = a[None] + e_pad[:, 0]
    alphas = [alpha]
    for t in range(1, Tmax):
        new = torch.logsumexp(alpha[:, :, None] + w[None], dim=1) \
            + e_pad[:, t]
        alpha = torch.where(active[:, t, None], new, alpha)
        alphas.append(alpha)
    log_z = torch.logsumexp(alpha + b[None], dim=-1)

    lbl = labels.clamp(0, D - 1)
    zero = torch.zeros((), dtype=e_pad.dtype, device=e_pad.device)
    e_at_lbl = torch.take_along_dim(e_pad, lbl[:, :, None], dim=2)[:, :, 0]
    e_score = torch.where(active, e_at_lbl, zero).sum(1)
    t_score = torch.where(active[:, 1:], w[lbl[:, :-1], lbl[:, 1:]],
                          zero).sum(1)
    last = (lengths - 1).clamp(min=0).long()
    last_lbl = torch.take_along_dim(lbl, last[:, None], dim=1)[:, 0]
    score = a[lbl[:, 0]] + e_score + t_score + b[last_lbl]
    nll = (log_z - score).reshape(-1, 1)

    alpha_rt = padded_to_ragged(torch.stack(alphas, 1), emission)
    return {"Alpha": [alpha_rt],
            "EmissionExps": [emission.with_values(
                torch.exp(emission.values))],
            "TransitionExps": [torch.exp(transition)],
            "LogLikelihood": [nll]}


def _keep_declared(block, op_desc):
    """The outputs keep the metas their layer declared: the JAX side
    infers no shapes for its host ops (`jittable=False`)."""


def viterbi_tags(emission, transition):
    """[B, Tmax] int64 Viterbi tags of a ragged emission [T, D] under
    `transition`, in float64: delta_0 = a + e_0; delta_t =
    max_i(delta_{t-1}[i] + w[i, :]) + e_t with the argmax kept while t
    is inside the sequence; the last tag is the argmax of delta + b, and
    the path is read back through the kept argmaxes.  Ties go to the
    first tag.  Steps past a length are 0."""
    e_pad, lengths = ragged_to_padded(emission)
    e_pad = e_pad.to(torch.float64)
    trans = transition.to(torch.float64)
    a, b, w = trans[0], trans[1], trans[2:]
    Tmax = e_pad.shape[1]
    delta = a[None] + e_pad[:, 0]
    back = []
    for t in range(1, Tmax):
        best, arg = torch.max(delta[:, :, None] + w[None], dim=1)
        inside = (t < lengths)[:, None]
        delta = torch.where(inside, best + e_pad[:, t], delta)
        back.append(arg)
    last = torch.argmax(delta + b[None], dim=-1)
    tags = []
    cur = last
    for t in range(Tmax - 1, -1, -1):
        cur = torch.where(lengths - 1 == t, last, cur)
        tags.append(cur)
        if t > 0:
            prev = torch.take_along_dim(back[t - 1], cur[:, None],
                                        dim=1)[:, 0]
            cur = torch.where(t <= lengths - 1, prev, cur)
    tags = torch.stack(tags[::-1], 1)
    t_idx = torch.arange(Tmax, dtype=lengths.dtype, device=lengths.device)
    return torch.where(t_idx[None, :] < lengths[:, None], tags,
                       torch.zeros((), dtype=tags.dtype,
                                   device=tags.device))


@register_op("crf_decoding", jittable=False, stop_gradient_op=True,
             nondiff_inputs=("Emission", "Transition", "Label"),
             infer_desc=_keep_declared)
def crf_decoding(ctx, ins, attrs):
    """ViterbiPath: the ragged [T, 1] int32 Viterbi tags over the
    emission's rows (`viterbi_tags`); with Label given, 1 where the tag
    equals the label and 0 elsewhere.  Rows past `nvalid` are 0."""
    emission = ins["Emission"][0]
    tags = viterbi_tags(emission, ins["Transition"][0])
    path = padded_to_ragged(tags[:, :, None].to(torch.int32), emission)
    if ins.get("Label") and ins["Label"][0] is not None:
        lv = ins["Label"][0].values.reshape(-1, 1).to(torch.int32)
        valid = emission.valid_mask()[:, None]
        path = path.with_values(((path.values == lv) & valid)
                                .to(torch.int32))
    return {"ViterbiPath": [path]}


def _extract_chunks(tags, num_types, scheme, excluded):
    """The set of (begin, end, type) chunks of a tag list (reference:
    chunk_eval_op.h's segment extraction).  Tags per scheme:
      plain: tag == type
      IOB:   tag = type*2 + (0 begin | 1 inside)
      IOE:   tag = type*2 + (0 inside | 1 end)
      IOBES: tag = type*4 + (0 begin | 1 inside | 2 end | 3 single)
    with one more 'outside' tag, num_types * the tag width."""
    chunks = []
    n = len(tags)
    i = 0
    if scheme == "plain":
        while i < n:
            t = tags[i]
            if 0 <= t < num_types:
                j = i
                while j + 1 < n and tags[j + 1] == t:
                    j += 1
                chunks.append((i, j, t))
                i = j + 1
            else:
                i += 1
    elif scheme == "IOB":
        while i < n:
            t = tags[i]
            if 0 <= t < num_types * 2:
                ctype = t // 2
                j = i
                while j + 1 < n and tags[j + 1] == ctype * 2 + 1:
                    j += 1
                chunks.append((i, j, ctype))
                i = j + 1
            else:
                i += 1
    elif scheme == "IOE":
        while i < n:
            t = tags[i]
            if 0 <= t < num_types * 2:
                ctype = t // 2
                j = i
                while j < n and tags[j] == ctype * 2 and j + 1 < n and \
                        tags[j + 1] // 2 == ctype:
                    j += 1
                if j < n and tags[j] // 2 == ctype:
                    chunks.append((i, j, ctype))
                    i = j + 1
                else:
                    i += 1
            else:
                i += 1
    elif scheme == "IOBES":
        while i < n:
            t = tags[i]
            if 0 <= t < num_types * 4:
                ctype, pos = divmod(t, 4)
                if pos == 3:
                    chunks.append((i, i, ctype))
                    i += 1
                elif pos == 0:
                    j = i
                    while (j + 1 < n and tags[j + 1] // 4 == ctype
                           and tags[j + 1] % 4 == 1):
                        j += 1
                    if j + 1 < n and tags[j + 1] // 4 == ctype and \
                            tags[j + 1] % 4 == 2:
                        j += 1
                    chunks.append((i, j, ctype))
                    i = j + 1
                else:
                    i += 1
            else:
                i += 1
    else:
        raise ValueError("unknown chunk scheme %r" % scheme)
    return {(b, e, t) for (b, e, t) in chunks if t not in excluded}


@register_op("chunk_eval", jittable=False, stop_gradient_op=True,
             nondiff_inputs=("Inference", "Label"),
             infer_desc=_keep_declared)
def chunk_eval(ctx, ins, attrs):
    """Chunk precision, recall and F1 of Inference against Label, with
    the chunk counts, over Label's sequences (reference:
    chunk_eval_op.cc), counted on the host."""
    inference, label = ins["Inference"][0], ins["Label"][0]
    num_types = int(attrs["num_chunk_types"])
    scheme = attrs.get("chunk_scheme", "IOB")
    excluded = set(attrs.get("excluded_chunk_types") or [])
    splits = label.last_splits().cpu().numpy()
    inf_v = inference.values.reshape(-1).cpu().numpy()
    lbl_v = label.values.reshape(-1).cpu().numpy()
    num_infer = num_label = num_correct = 0
    for s in range(len(splits) - 1):
        lo, hi = int(splits[s]), int(splits[s + 1])
        ic = _extract_chunks(inf_v[lo:hi].tolist(), num_types, scheme,
                             excluded)
        lc = _extract_chunks(lbl_v[lo:hi].tolist(), num_types, scheme,
                             excluded)
        num_infer += len(ic)
        num_label += len(lc)
        num_correct += len(ic & lc)
    precision = num_correct / num_infer if num_infer else 0.0
    recall = num_correct / num_label if num_label else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if num_correct else 0.0)
    dev = label.values.device

    def out(v, dtype):
        return torch.as_tensor(np.asarray([v], dtype), device=dev)

    return {"Precision": [out(precision, np.float32)],
            "Recall": [out(recall, np.float32)],
            "F1-Score": [out(f1, np.float32)],
            "NumInferChunks": [out(num_infer, np.int32)],
            "NumLabelChunks": [out(num_label, np.int32)],
            "NumCorrectChunks": [out(num_correct, np.int32)]}
