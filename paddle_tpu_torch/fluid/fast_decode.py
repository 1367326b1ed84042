"""Generation over a single-step fluid Program.

Counterpart of paddle_tpu/fluid/fast_decode.py.  A user expresses ONE
decode step as an ordinary inference Program (token in, logits out,
recurrent state threaded through named feed/fetch pairs), and
`ProgramDecoder` runs the generation loop over it (models/decode.py)
with the trained weights taken from the scope onto the card.  The JAX
package compiles the whole loop into one executable per configuration;
here the loop runs in Python and each step runs the program op by op
(`jit.FunctionalProgram`), with every tensor kept on the device and one
copy of the result to the host at the end.

Usage:
    decoder = ProgramDecoder(step_prog, token_name="tok",
                             logits_name=logits.name,
                             state_pairs=[("h_in", h_out.name)])
    toks, lengths = decoder.greedy(bos=1, eos=0, max_len=32,
                                   init_state={"h_in": h0})
    seqs, scores = decoder.beam(beam_size=4, bos=1, eos=0, max_len=32,
                                init_state={"h_in": h0})
"""

import numpy as np
import torch

from .. import jit
from ..core.types import tensor_from_numpy
from ..models.decode import (beam_search_decode_dense, eos_lengths,
                             greedy_decode, prefill, sample_decode)
from .executor import CUDAPlace, prepare_feed

__all__ = ["ProgramDecoder"]


class ProgramDecoder:
    """Greedy, sampled and beam generation from a single-step Program.

    The step program's contract: it reads a token feed (int tensor
    [batch]), any number of state feeds ([batch, ...]), and fetches
    logits ([batch, vocab]) plus one new-state fetch per state feed
    (`state_pairs` lists (feed_name, fetch_var_name) in order).
    Parameters and other persistables come from `scope` (default: the
    global scope the program was trained in) onto the device of `place`:
    CUDAPlace(0) unless the caller asks for another, raising without a
    CUDA device.  `max_positions` is the step program's position extent
    (KV-cache length, position-embedding rows): a decode that would
    write past it raises ValueError before any step runs.
    """

    def __init__(self, program, token_name, logits_name, state_pairs=(),
                 scope=None, max_positions=None, place=None):
        self.token_name = token_name
        self.state_pairs = list(state_pairs)
        self.max_positions = max_positions
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.device()
        feed_names = [token_name] + [f for f, _ in self.state_pairs]
        fetch_names = [logits_name] + [o for _, o in self.state_pairs]
        self._fp = jit.FunctionalProgram(program, feed_names, fetch_names,
                                         place=self.place)
        self._block = self._fp.desc.block(0)
        self._params = {
            n: (v if isinstance(v, torch.Tensor)
                else tensor_from_numpy(v, "cpu")).to(self.device)
            for n, v in jit.state_from_scope(self._fp, scope).items()}
        missing = sorted(set(self._fp.state_in_names) - set(self._params))
        if missing:
            raise ValueError(
                "scope has no values for %s — run the startup program "
                "(and training) in this scope before building the "
                "decoder" % missing)

    def _step(self, state, tok):
        feeds = {self.token_name: tok}
        feeds.update(state)
        (logits, *new_states), _ = self._fp(self._params, feeds)
        return logits, {f: ns for (f, _), ns in zip(self.state_pairs,
                                                    new_states)}

    def _feed(self, name, value):
        return prepare_feed(self._block, name, value, self.device)

    def _prep(self, init_state, batch_size):
        state = dict(init_state or {})
        missing = [f for f, _ in self.state_pairs if f not in state]
        if missing:
            raise ValueError("init_state missing %s" % missing)
        known = {f for f, _ in self.state_pairs}
        extra = sorted(set(state) - known)
        if extra:
            raise ValueError(
                "init_state has keys %s that are not in state_pairs %s"
                % (extra, sorted(known)))
        state = {f: self._feed(f, v) for f, v in state.items()}
        if batch_size is None:
            if not state:
                raise ValueError(
                    "batch_size is required when the step program has "
                    "no state feeds")
            batch_size = next(iter(state.values())).shape[0]
        return state, batch_size

    def _check_extent(self, max_len, prompt_len=0):
        if self.max_positions is None:
            return
        need = prompt_len + max_len - 1 if prompt_len else max_len
        if need > self.max_positions:
            raise ValueError(
                "decoding %d positions (prompt %d + %d generated) "
                "exceeds the step program's extent %d — the cache write "
                "would clamp and corrupt the cache"
                % (need, prompt_len, max_len, self.max_positions))

    def _norm_prompt(self, prompt, max_len):
        """Validate the optional prompt and move it to the device as the
        token feed; None without one."""
        if prompt is None:
            self._check_extent(max_len)
            return None
        shape = tuple(prompt.shape) if isinstance(prompt, torch.Tensor) \
            else np.shape(prompt)
        if len(shape) != 2 or shape[1] == 0:
            raise ValueError(
                "prompt must be [batch, P>=1] tokens, got shape %s"
                % (shape,))
        self._check_extent(max_len, shape[1])
        return self._feed(self.token_name, prompt)

    def _prefilled_run(self, state, prompt, decode_fn, eos, max_len):
        """Prefill, then decode_fn(state, first) for the remaining
        max_len-1 tokens (none when max_len == 1: the 'predict one
        continuation token' call)."""
        state, first = prefill(self._step, state, prompt)
        if max_len == 1:
            toks = first[:, None]
        else:
            toks, _ = decode_fn(state, first)
            toks = torch.cat([first[:, None], toks], dim=1)
        return toks, eos_lengths(toks, eos, max_len)

    @staticmethod
    def _host(*tensors):
        return tuple(t.cpu().numpy() for t in tensors)

    def greedy(self, bos, eos, max_len, batch_size=None, init_state=None,
               prompt=None):
        """Returns (tokens [batch, max_len], lengths [batch]) as numpy
        arrays.

        `prompt` (int [batch, P]) warms the decode state through the
        step program first (for a KV-cache step program this is the
        prefill); the first output token is then the prompt's
        continuation and `bos` is ignored."""
        with torch.inference_mode():
            state, batch_size = self._prep(init_state, batch_size)
            prompt = self._norm_prompt(prompt, max_len)
            if prompt is None:
                return self._host(*greedy_decode(
                    self._step, state, bos=bos, eos=eos, max_len=max_len,
                    batch_size=batch_size, device=self.device))
            return self._host(*self._prefilled_run(
                state, prompt,
                lambda st, first: greedy_decode(
                    self._step, st, bos=first, eos=eos,
                    max_len=max_len - 1, batch_size=batch_size),
                eos, max_len))

    def sample(self, bos, eos, max_len, batch_size=None, init_state=None,
               prompt=None, seed=0, temperature=1.0, top_k=0):
        """Ancestral sampling (temperature, top-k), drawn from a
        torch.Generator on the device seeded with `seed`.  With
        `prompt`, prefills first and samples the continuation."""
        with torch.inference_mode():
            state, batch_size = self._prep(init_state, batch_size)
            prompt = self._norm_prompt(prompt, max_len)
            gen = torch.Generator(device=self.device).manual_seed(seed)

            def run(st, first, n):
                return sample_decode(
                    self._step, st, bos=first, eos=eos, max_len=n,
                    batch_size=batch_size, generator=gen,
                    temperature=temperature, top_k=top_k,
                    device=self.device)

            if prompt is None:
                return self._host(*run(state, bos, max_len))
            return self._host(*self._prefilled_run(
                state, prompt, lambda st, first: run(st, first, max_len - 1),
                eos, max_len))

    def beam(self, beam_size, bos, eos, max_len, batch_size=None,
             init_state=None, length_penalty=0.0):
        """Returns (sequences [batch, beam, max_len], scores
        [batch, beam]) as numpy arrays, best first."""
        with torch.inference_mode():
            state, batch_size = self._prep(init_state, batch_size)
            self._check_extent(max_len)
            return self._host(*beam_search_decode_dense(
                self._step, state, bos=bos, eos=eos, beam_size=beam_size,
                max_len=max_len, batch_size=batch_size,
                length_penalty=length_penalty, device=self.device))
