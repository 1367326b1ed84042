"""Dense (static-shape) autoregressive decoding over device tensors.

Counterpart of paddle_tpu/models/decode.py, where each decoder is one
`lax.scan` that XLA compiles.  Here each is a Python loop over the same
body on tensors that stay on the step's device: every loop runs all
`max_len` steps, as the scan does (no early exit on `done`, which would
read the device from the host each step), and the tokens, `done`
flags, scores and parent pointers stay on the device until the caller
copies the result once.

`step_fn(state, tokens [B]) -> (logits [B, V], new_state)`, where state
is a dict of tensors whose leading dim is the batch.  `bos` may be a
scalar or a per-row [B] tensor (prefill's continuation tokens).
"""

import torch

from ..ops.tensor_ops import stable_top_k as _top_k

__all__ = ["greedy_decode", "beam_search_decode_dense", "prefill",
           "sample_decode", "eos_lengths"]

NEG_INF = -1e30


def _device(bos, state, device):
    if device is not None:
        return torch.device(device)
    if isinstance(bos, torch.Tensor):
        return bos.device
    for v in state.values():
        return v.device
    return torch.device("cpu")


def _start(bos, eos, batch_size, device):
    """(tokens [B] int32, done [B]): per-row seeds that are already eos
    are done from the start; a SCALAR bos may deliberately equal eos (the
    GPT-2 endoftext convention) and must still generate."""
    bos = torch.as_tensor(bos, dtype=torch.int32, device=device)
    tok = bos.expand(batch_size).clone()
    done = (tok == eos) if bos.dim() else \
        torch.zeros(batch_size, dtype=torch.bool, device=device)
    return tok, done


def eos_lengths(toks, eos, max_len):
    """Each row's length up to and including its first eos, else
    max_len (int32 [B])."""
    hit = toks == eos
    first = hit.to(torch.int32).argmax(dim=1) + 1
    return torch.where(hit.any(dim=1), first,
                       torch.full_like(first, max_len)).to(torch.int32)


def prefill(step_fn, init_state, prompt):
    """Feed a prompt through the step function, returning (state,
    first_token), where first_token [B] int32 is the argmax of the last
    prompt position's logits, the continuation to seed the decode with.
    prompt: int [B, P] on the step's device.  Only the last logits are
    kept."""
    toks = prompt.to(torch.int32).t()             # [P, B]
    logits, state = step_fn(init_state, toks[0])
    for tok in toks[1:]:
        logits, state = step_fn(state, tok)
    return state, logits.argmax(dim=-1).to(torch.int32)


def greedy_decode(step_fn, init_state, bos, eos, max_len, batch_size,
                  device=None):
    """Returns (tokens [B, max_len] int32, lengths [B] int32).  A row
    that emitted eos emits eos from then on."""
    device = _device(bos, init_state, device)
    tok, done = _start(bos, eos, batch_size, device)
    state, out = init_state, []
    for _ in range(max_len):
        logits, state = step_fn(state, tok)
        tok = logits.argmax(dim=-1).to(torch.int32).masked_fill(done, eos)
        done = done | (tok == eos)
        out.append(tok)
    toks = torch.stack(out, dim=1) if out else \
        torch.empty((batch_size, 0), dtype=torch.int32, device=device)
    return toks, eos_lengths(toks, eos, max_len)


def sample_decode(step_fn, init_state, bos, eos, max_len, batch_size,
                  generator, temperature=1.0, top_k=0, device=None):
    """Ancestral sampling: per step a categorical draw from the
    temperature-scaled logits, truncated to those not below the k-th
    largest with `top_k` (ties at the k-th value stay in), by the
    Gumbel-max rule of `jax.random.categorical`, with uniforms from
    `generator` (a torch.Generator on the step's device).  JAX's PRNG
    stream is not reproduced: the same generator state gives the same
    tokens here.  Returns (tokens [B, max_len], lengths [B])."""
    device = _device(bos, init_state, device)
    tok, done = _start(bos, eos, batch_size, device)
    tiny = torch.finfo(torch.float32).tiny
    state, out = init_state, []
    for _ in range(max_len):
        logits, state = step_fn(state, tok)
        logits = logits.float() / max(temperature, 1e-6)
        if top_k:
            kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
            logits = logits.masked_fill(logits < kth, NEG_INF)
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device).clamp_min_(tiny)
        gumbel = -torch.log(-torch.log(u))
        tok = (logits + gumbel).argmax(dim=-1).to(torch.int32) \
            .masked_fill(done, eos)
        done = done | (tok == eos)
        out.append(tok)
    toks = torch.stack(out, dim=1) if out else \
        torch.empty((batch_size, 0), dtype=torch.int32, device=device)
    return toks, eos_lengths(toks, eos, max_len)


def beam_search_decode_dense(step_fn, init_state, bos, eos, beam_size,
                             max_len, batch_size, length_penalty=0.0,
                             device=None):
    """Batched beam search.  step_fn sees N = batch * beam rows, every
    state tensor repeated beam times.  Returns (tokens [B, beam,
    max_len] int32, scores [B, beam] f32), best first; with
    `length_penalty`, scores are divided by length ** length_penalty
    (the length up to and including the first eos)."""
    B, K = batch_size, beam_size
    device = _device(bos, init_state, device)
    state = {n: t.repeat_interleave(K, dim=0) for n, t in init_state.items()}
    tok = torch.as_tensor(bos, dtype=torch.int32, device=device) \
        .expand(B).repeat_interleave(K)
    # only beam 0 alive at t=0, so the first top-k doesn't pick K copies
    scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    scores = scores.reshape(-1)
    done = torch.zeros(B * K, dtype=torch.bool, device=device)
    base = torch.arange(B, device=device)[:, None] * K
    eos_only = None
    toks, parents = [], []
    for _ in range(max_len):
        logits, new_state = step_fn(state, tok)
        V = logits.shape[-1]
        if eos_only is None:
            # finished beams: only eos continues, at no cost (an eos
            # outside the vocabulary sets nothing, as the JAX side's
            # out-of-bounds scatter drops it)
            eos_only = torch.full((V,), NEG_INF, dtype=torch.float32,
                                  device=device)
            if -V <= eos < V:
                eos_only[eos] = 0.0
        logp = torch.log_softmax(logits.float(), dim=-1)
        logp = torch.where(done[:, None], eos_only[None, :], logp)
        total = (scores[:, None] + logp).reshape(B, K * V)
        top_scores, top_idx = _top_k(total, K)             # [B, K]
        beam_idx = top_idx // V
        tok_idx = (top_idx % V).to(torch.int32)
        src = (base + beam_idx).reshape(-1)
        state = {n: t[src] for n, t in new_state.items()}
        tok = tok_idx.reshape(-1)
        scores = top_scores.reshape(-1)
        done = done[src] | (tok == eos)
        toks.append(tok_idx)
        parents.append(beam_idx)

    # backtrack through the per-step parent pointers
    beam = torch.arange(K, device=device).expand(B, K)
    rev = []
    for tok_t, par_t in zip(reversed(toks), reversed(parents)):
        rev.append(tok_t.gather(1, beam))
        beam = par_t.gather(1, beam)
    sequences = torch.stack(rev[::-1], dim=2) if rev else \
        torch.empty((B, K, 0), dtype=torch.int32, device=device)
    final = scores.reshape(B, K)
    if length_penalty:
        lengths = ((sequences == eos).cumsum(dim=2) == 0).sum(dim=2) + 1
        final = final / lengths.float() ** length_penalty
    order = torch.argsort(-final, dim=1, stable=True)
    return sequences.gather(1, order[:, :, None].expand_as(sequences)), \
        final.gather(1, order)
