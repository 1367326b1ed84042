"""Generation in the port against the JAX package, on the CPU.

- The decode functions (models/decode.py) against the JAX package's with
  a table scorer as the step (scripts/bench_decode.py's): greedy tokens
  and lengths, the scalar- and per-row-`bos` rules, beam sequences and
  scores with and without a length penalty, ties, beam(1) equal to
  greedy, and prefill.  Tokens exactly; scores at atol 1e-5 (sums of up
  to 10 f32 log-softmaxes, computed in other orders).
- `fluid.ProgramDecoder` over the KV-cached transformer step after the
  JAX package trains it with Adam (6 steps, tests/test_cached_decode.py's
  size), over the sliding-window step at examples/transformer_lm.py's
  default size, and over tests/test_fast_decode.py's RNN step: tokens
  equal JAX's token for token; step logits along JAX's trajectory at
  atol 1e-5 (f32, 2 layers, sums in other orders); the validation errors.
- Sampling: the port draws from a torch.Generator and cannot reproduce
  JAX's PRNG stream, so it is held to the limits (temperature -> 0 and
  top_k=1 are greedy, a seed repeats) and to the distribution: one
  step's token frequencies over 4000 rows against softmax(logits / T).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import decode as jdec
from paddle_tpu.models import transformer_program as jtp
from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid import CPUPlace, Executor, Scope, io
from paddle_tpu_torch.models import decode as pdec
from paddle_tpu_torch.models import transformer_program as ptp

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

CPU = CPUPlace()


# -- the decode functions, with a table scorer -------------------------------

def _scorers(V, C, seed=0, ties=False):
    """(JAX step, port step): logits table[tok, min(t, C-1)] and t + 1.
    With `ties`, integer logits, so equal scores are common."""
    rs = np.random.RandomState(seed)
    table = (rs.randint(0, 3, (V, C, V)) if ties
             else rs.randn(V, C, V)).astype(np.float32)
    jt, pt = jnp.asarray(table), torch.from_numpy(table)

    def jstep(state, tok):
        t = state["t"]
        return jt[tok, jnp.minimum(t, C - 1)], {"t": t + 1}

    def pstep(state, tok):
        t = state["t"]
        return pt[tok.long(), t.clamp(max=C - 1).long()], {"t": t + 1}

    return jstep, pstep


def _state(B):
    return {"t": jnp.zeros((B,), jnp.int32)}, \
        {"t": torch.zeros(B, dtype=torch.int32)}


@pytest.mark.parametrize("bos", [1, 0, "rows"])
def test_greedy_matches_jax(bos):
    """eos 0 is frequent in a 5-word vocabulary.  A scalar bos equal to
    eos still generates; per-row seeds that are eos are done at once."""
    B, V, L = 6, 5, 9
    jstep, pstep = _scorers(V, 4)
    js, ps = _state(B)
    if bos == "rows":
        jb = jnp.asarray([0, 1, 2, 3, 4, 0], jnp.int32)
        pb = torch.tensor([0, 1, 2, 3, 4, 0], dtype=torch.int32)
    else:
        jb = pb = bos
    jt, jl = jdec.greedy_decode(jstep, js, bos=jb, eos=0, max_len=L,
                                batch_size=B)
    pt, pl = pdec.greedy_decode(pstep, ps, bos=pb, eos=0, max_len=L,
                                batch_size=B)
    assert pt.dtype == pl.dtype == torch.int32
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    if bos == "rows":
        assert (pt.numpy()[[0, 5]] == 0).all()


@pytest.mark.parametrize("length_penalty", [0.0, 0.7])
@pytest.mark.parametrize("ties", [False, True])
def test_beam_matches_jax(length_penalty, ties):
    """With integer logits, equal totals are common: the top-k takes the
    lower index first and the final sort is stable, as in JAX."""
    B, K, V, L = 3, 4, 6, 7
    jstep, pstep = _scorers(V, 5, seed=1, ties=ties)
    js, ps = _state(B)
    jseq, jsc = jdec.beam_search_decode_dense(
        jstep, js, bos=1, eos=0, beam_size=K, max_len=L, batch_size=B,
        length_penalty=length_penalty)
    pseq, psc = pdec.beam_search_decode_dense(
        pstep, ps, bos=1, eos=0, beam_size=K, max_len=L, batch_size=B,
        length_penalty=length_penalty)
    assert pseq.dtype == torch.int32 and psc.dtype == torch.float32
    np.testing.assert_array_equal(pseq.numpy(), np.asarray(jseq))
    np.testing.assert_allclose(psc.numpy(), np.asarray(jsc), atol=1e-5)
    assert (np.asarray(jseq) == 0).any()   # some beams finished


def test_beam_of_one_equals_greedy():
    B, V, L = 4, 7, 8
    _, pstep = _scorers(V, 6, seed=2)
    _, ps = _state(B)
    toks, _ = pdec.greedy_decode(pstep, ps, bos=2, eos=0, max_len=L,
                                 batch_size=B)
    seqs, scores = pdec.beam_search_decode_dense(
        pstep, ps, bos=2, eos=0, beam_size=1, max_len=L, batch_size=B)
    np.testing.assert_array_equal(seqs[:, 0].numpy(), toks.numpy())
    assert torch.isfinite(scores).all()


def test_prefill_matches_jax():
    B, V, P = 5, 9, 4
    jstep, pstep = _scorers(V, 6, seed=3)
    js, ps = _state(B)
    prompt = np.random.RandomState(4).randint(0, V, (B, P))
    jstate, jfirst = jdec.prefill(jstep, js, jnp.asarray(prompt))
    pstate, pfirst = pdec.prefill(pstep, ps, torch.from_numpy(prompt))
    assert pfirst.dtype == torch.int32
    np.testing.assert_array_equal(pfirst.numpy(), np.asarray(jfirst))
    np.testing.assert_array_equal(pstate["t"].numpy(),
                                  np.asarray(jstate["t"]))


# -- ProgramDecoder over the KV-cached step ----------------------------------

B, T, V, L, H, D = 4, 16, 32, 2, 2, 16


@pytest.fixture(scope="module")
def trained():
    """The JAX package's scope after 6 Adam steps, as numpy arrays."""
    main, startup, avg_loss, _ = jtp.build_transformer_program(
        B, T, V, n_layer=L, n_head=H, d_model=D)
    with jfluid.program_guard(main, startup):
        jfluid.optimizer.Adam(learning_rate=5e-3).minimize(avg_loss)
    scope = JScope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(startup)
        for i in range(6):
            exe.run(main, feed=jtp.transformer_program_feeds(B, T, V,
                                                             seed=i),
                    fetch_list=[avg_loss])
    return {n: np.array(scope.get(n)) for n, v in
            main.desc.block(0).vars.items() if v.persistable}


def _init_state():
    init = {"pos": np.zeros((B,), np.int64)}
    for i in range(L):
        for kv in "kv":
            init["%s_cache_%d" % (kv, i)] = np.zeros((B, H, T, D // H),
                                                     np.float32)
    return init


def _decoders(trained, rows):
    """(JAX decoder, port decoder) over the cached step built for
    `rows` rows, each from its own package's scope holding the same
    trained values."""
    jscope = JScope()
    for n, v in trained.items():
        jscope.set(n, jnp.asarray(v))
    prog, _, logits, pairs = jtp.build_transformer_cached_step_program(
        rows, T, V, n_layer=L, n_head=H, d_model=D)
    jd = jfluid.ProgramDecoder(prog.clone(for_test=True), token_name="tok",
                               logits_name=logits.name, state_pairs=pairs,
                               scope=jscope, max_positions=T)
    pscope = Scope()
    io.params_from_numpy(pscope, trained, "cpu")
    prog, _, logits, pairs = ptp.build_transformer_cached_step_program(
        rows, T, V, n_layer=L, n_head=H, d_model=D)
    pd = fluid.ProgramDecoder(prog.clone(for_test=True), token_name="tok",
                              logits_name=logits.name, state_pairs=pairs,
                              scope=pscope, max_positions=T, place=CPU)
    return jd, pd


@pytest.fixture(scope="module")
def decoders(trained):
    return _decoders(trained, B)


def test_cached_greedy_matches_jax(decoders):
    jd, pd = decoders
    jt, jl = jd.greedy(bos=3, eos=V + 1, max_len=10, batch_size=B,
                       init_state=_init_state())
    pt, pl = pd.greedy(bos=3, eos=V + 1, max_len=10, batch_size=B,
                       init_state=_init_state())
    assert isinstance(pt, np.ndarray) and pt.shape == (B, 10)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pl, jl)


def test_cached_prompted_greedy_matches_jax(decoders):
    jd, pd = decoders
    prompt = np.random.RandomState(7).randint(0, V, (B, 5)).astype(np.int64)
    for max_len in (1, 6, T - 4):
        jt, jl = jd.greedy(bos=0, eos=V + 1, max_len=max_len, batch_size=B,
                           init_state=_init_state(), prompt=prompt)
        pt, pl = pd.greedy(bos=0, eos=V + 1, max_len=max_len, batch_size=B,
                           init_state=_init_state(), prompt=prompt)
        np.testing.assert_array_equal(pt, jt)
        np.testing.assert_array_equal(pl, jl)


@pytest.mark.parametrize("beam_size,length_penalty", [(1, 0.0), (3, 0.0),
                                                      (3, 1.0)])
def test_cached_beam_matches_jax(trained, beam_size, length_penalty):
    """The beam's rows are batch * beam_size: the step program is built
    for them, and the caches are fed for the batch."""
    jd, pd = _decoders(trained, B * beam_size)
    kw = dict(beam_size=beam_size, bos=3, eos=5, max_len=8, batch_size=B,
              length_penalty=length_penalty)
    js, jsc = jd.beam(init_state=_init_state(), **kw)
    ps, psc = pd.beam(init_state=_init_state(), **kw)
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_allclose(psc, jsc, atol=1e-5)
    if beam_size == 1:
        toks, _ = pd.greedy(bos=3, eos=5, max_len=8, batch_size=B,
                            init_state=_init_state())
        np.testing.assert_array_equal(ps[:, 0], toks)


def test_cached_step_logits_along_jax_trajectory(decoders):
    """The port's step fed JAX's greedy tokens: logits at atol 1e-5."""
    jd, pd = decoders
    jt, _ = jd.greedy(bos=3, eos=V + 1, max_len=T, batch_size=B,
                      init_state=_init_state())
    jstep = jd._step_fn(jd._params)
    jstate = {n: jnp.asarray(v) for n, v in _init_state().items()}
    jstate["pos"] = jstate["pos"].astype(jnp.int32)
    pstate = {n: pd._feed(n, v) for n, v in _init_state().items()}
    tokens = np.concatenate([np.full((B, 1), 3), jt[:, :-1]], axis=1)
    for t in range(T):
        jl, jstate = jstep(jstate, jnp.asarray(tokens[:, t], jnp.int32))
        pl, pstate = pd._step(pstate, torch.from_numpy(
            tokens[:, t].astype(np.int32)))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-5,
                                   err_msg="step %d" % t)
        assert pstate["pos"].dtype == torch.int32
    assert int(pstate["pos"][0]) == T


def test_cached_decoder_errors(decoders):
    _, pd = decoders
    prompt = np.zeros((B, 5), np.int64)
    with pytest.raises(ValueError, match="extent"):
        pd.greedy(bos=0, eos=V + 1, max_len=T - 3, batch_size=B,
                  init_state=_init_state(), prompt=prompt)
    with pytest.raises(ValueError, match="extent"):
        pd.beam(beam_size=2, bos=0, eos=V + 1, max_len=T + 1,
                batch_size=B, init_state=_init_state())
    with pytest.raises(ValueError, match="P>=1"):
        pd.greedy(bos=0, eos=V + 1, max_len=2, batch_size=B,
                  init_state=_init_state(), prompt=np.zeros((B, 0), np.int64))
    state = _init_state()
    del state["v_cache_1"]
    with pytest.raises(ValueError, match="init_state missing"):
        pd.greedy(bos=0, eos=V + 1, max_len=2, init_state=state)
    state = dict(_init_state(), extra=np.zeros(B))
    with pytest.raises(ValueError, match="not in state_pairs"):
        pd.greedy(bos=0, eos=V + 1, max_len=2, init_state=state)
    with pytest.raises(OverflowError):
        pd.greedy(bos=0, eos=V + 1, max_len=2, batch_size=B,
                  init_state=dict(_init_state(),
                                  pos=np.full((B,), 2 ** 40, np.int64)))


def test_decoder_validation_without_state(trained):
    prog, _, logits, _ = ptp.build_transformer_cached_step_program(
        B, T, V, n_layer=L, n_head=H, d_model=D)
    scope = Scope()
    io.params_from_numpy(scope, trained, "cpu")
    dec = fluid.ProgramDecoder(prog, token_name="tok",
                               logits_name=logits.name, scope=scope,
                               place=CPU)
    with pytest.raises(ValueError, match="batch_size is required"):
        dec.greedy(bos=0, eos=1, max_len=2)
    with pytest.raises(ValueError, match="scope has no values"):
        fluid.ProgramDecoder(prog, token_name="tok",
                             logits_name=logits.name, scope=Scope(),
                             place=CPU)


# -- ProgramDecoder over the sliding-window step -----------------------------

def test_window_greedy_matches_jax():
    """examples/transformer_lm.py's default size: batch 16, seq 32,
    vocab 64, d_model 64, 2 layers, 4 heads; 2 Adam steps, then 4 rows
    over a 32-token window."""
    batch, seq, vocab, d_model, gen = 16, 32, 64, 64, 4
    main, startup, loss, _ = jtp.build_transformer_program(
        batch, seq, vocab, n_layer=2, n_head=4, d_model=d_model)
    with jfluid.program_guard(main, startup):
        jfluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    jscope = JScope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        exe.run(startup)
        for i in range(2):
            exe.run(main, feed=jtp.transformer_program_feeds(
                batch, seq, vocab, seed=i), fetch_list=[loss])
    pscope = Scope()
    io.params_from_numpy(pscope, {n: np.array(jscope.get(n)) for n in
                                  jscope._vars if jscope.get(n) is not None},
                         "cpu")
    rs = np.random.RandomState(5)
    window = rs.randint(0, vocab, (gen, seq)).astype(np.int64)
    positions = np.tile(np.arange(seq), (gen, 1)).astype(np.int64)
    toks = []
    for tp, fl, scope, kw in ((jtp, jfluid, jscope, {}),
                              (ptp, fluid, pscope, {"place": CPU})):
        prog, _, logits, new_window = tp.build_transformer_step_program(
            gen, seq, vocab, n_layer=2, n_head=4, d_model=d_model)
        dec = fl.ProgramDecoder(
            prog.clone(for_test=True), token_name="tok",
            logits_name=logits.name, scope=scope,
            state_pairs=[("window", new_window.name),
                         ("positions", "positions")], **kw)
        toks.append(dec.greedy(bos=int(window[0, -1]), eos=vocab + 1,
                               max_len=8, init_state={
                                   "window": window,
                                   "positions": positions})[0])
    np.testing.assert_array_equal(toks[1], toks[0])


# -- ProgramDecoder over tests/test_fast_decode.py's RNN step ----------------

RV, RE, RH = 23, 12, 16


def _rnn_step_program(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        tok = fl.layers.data(name="tok", shape=[-1], dtype="int64",
                             append_batch_size=False)
        h_in = fl.layers.data(name="h_in", shape=[-1, RH], dtype="float32",
                              append_batch_size=False)
        emb = fl.layers.embedding(tok, size=[RV, RE])
        h_out = fl.layers.fc(input=[emb, h_in], size=RH, act="tanh")
        logits = fl.layers.fc(input=h_out, size=RV, act=None)
    return main, startup, h_out, logits


@pytest.fixture(scope="module")
def rnn():
    """(port step program, h_out, logits, port scope, JAX decoder): the
    JAX package's startup state, transplanted."""
    main, startup, h_out, logits = _rnn_step_program(jfluid)
    scope = JScope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    jd = jfluid.ProgramDecoder(main, token_name="tok",
                               logits_name=logits.name,
                               state_pairs=[("h_in", h_out.name)],
                               scope=scope)
    params = {n: np.array(scope.get(n)) for n, v in
              main.desc.block(0).vars.items() if v.persistable}
    pmain, _, ph, pl = _rnn_step_program(fluid)
    pscope = Scope()
    io.params_from_numpy(pscope, params, "cpu")
    return pmain, ph, pl, pscope, jd


def _rnn_decoder(rnn):
    pmain, ph, pl, pscope, _ = rnn
    return fluid.ProgramDecoder(pmain, token_name="tok",
                                logits_name=pl.name,
                                state_pairs=[("h_in", ph.name)],
                                scope=pscope, place=CPU)


def test_rnn_greedy_matches_executor_loop_and_jax(rnn):
    pmain, ph, pl, pscope, jd = rnn
    batch, max_len = 5, 12
    init = {"h_in": np.zeros((batch, RH), np.float32)}
    toks, lengths = _rnn_decoder(rnn).greedy(bos=1, eos=0, max_len=max_len,
                                             init_state=init)
    exe = Executor(CPU)
    tok = np.full((batch,), 1, np.int64)
    h = init["h_in"]
    done = np.zeros(batch, bool)
    want = []
    for _ in range(max_len):
        lg, h = exe.run(pmain, feed={"tok": tok, "h_in": h},
                        fetch_list=[pl, ph], scope=pscope)
        nxt = np.where(done, 0, np.argmax(lg, axis=-1))
        done |= nxt == 0
        want.append(nxt)
        tok = nxt.astype(np.int64)
    np.testing.assert_array_equal(toks, np.stack(want, axis=1))
    jt, jl = jd.greedy(bos=1, eos=0, max_len=max_len, init_state=init)
    np.testing.assert_array_equal(toks, jt)
    np.testing.assert_array_equal(lengths, jl)


def test_sampling_limits_and_seeds(rnn):
    dec = _rnn_decoder(rnn)
    init = {"h_in": np.zeros((6, RH), np.float32)}
    greedy, _ = dec.greedy(bos=1, eos=0, max_len=10, init_state=init)
    cold, _ = dec.sample(bos=1, eos=0, max_len=10, init_state=init,
                         temperature=1e-5)
    np.testing.assert_array_equal(cold, greedy)
    top1, _ = dec.sample(bos=1, eos=0, max_len=10, init_state=init,
                         top_k=1)
    np.testing.assert_array_equal(top1, greedy)
    a, la = dec.sample(bos=1, eos=0, max_len=10, init_state=init, seed=3,
                       temperature=1.5)
    b, lb = dec.sample(bos=1, eos=0, max_len=10, init_state=init, seed=3,
                       temperature=1.5)
    c, _ = dec.sample(bos=1, eos=0, max_len=10, init_state=init, seed=4,
                      temperature=1.5)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)
    assert not np.array_equal(a, c)


def _first_step_logits(rnn, rows):
    pmain, ph, pl, pscope, _ = rnn
    lg, = Executor(CPU).run(pmain, feed={
        "tok": np.full((rows,), 1, np.int64),
        "h_in": np.zeros((rows, RH), np.float32)},
        fetch_list=[pl], scope=pscope)
    return lg[0]


@pytest.mark.parametrize("temperature", [0.5, 1.5])
def test_sampling_frequencies_match_softmax(rnn, temperature):
    """4000 rows from the same state: each token's frequency within 5
    standard errors (sqrt(p (1 - p) / 4000)) plus 1e-3 of
    softmax(logits / T); a draw that ignored T or mis-scaled the logits
    misses by far more."""
    rows = 4000
    toks, _ = _rnn_decoder(rnn).sample(
        bos=1, eos=-1, max_len=1, seed=11, temperature=temperature,
        init_state={"h_in": np.zeros((rows, RH), np.float32)})
    z = _first_step_logits(rnn, 1).astype(np.float64) / temperature
    p = np.exp(z - z.max())
    p /= p.sum()
    freq = np.bincount(toks[:, 0], minlength=RV) / rows
    bound = 5 * np.sqrt(p * (1 - p) / rows) + 1e-3
    assert np.all(np.abs(freq - p) <= bound), np.abs(freq - p) / bound


def test_sampling_top_k_keeps_to_the_top_k(rnn):
    rows, k = 2000, 3
    toks, _ = _rnn_decoder(rnn).sample(
        bos=1, eos=-1, max_len=1, seed=12, temperature=2.0, top_k=k,
        init_state={"h_in": np.zeros((rows, RH), np.float32)})
    top = set(np.argsort(-_first_step_logits(rnn, 1))[:k].tolist())
    assert set(np.unique(toks[:, 0]).tolist()) == top


# -- FunctionalProgram --------------------------------------------------------

def test_functional_program_threads_state_through_the_scope():
    """A block that reads a parameter and bumps a persistable counter in
    place: state in and out from the scope's names, a fetch that names a
    feed, and the new state written back by state_to_scope."""
    from paddle_tpu_torch.jit import (FunctionalProgram, state_from_scope,
                                      state_to_scope)

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[3, 4], dtype="float32",
                              append_batch_size=False)
        y = fluid.layers.fc(input=x, size=2, bias_attr=False)
        count = fluid.layers.create_global_var(shape=[1], value=0,
                                               dtype="int32",
                                               persistable=True,
                                               name="count")
        fluid.layers.increment(count, value=1)
    scope = Scope()
    Executor(CPU).run(startup, scope=scope)
    fp = FunctionalProgram(main, ["x"], [y.name, "x"], place=CPU)
    assert fp.state_in_names == ["count", "fc_0.w_0"]
    assert fp.state_out_names == ["count"]
    state = state_from_scope(fp, scope)
    xs = torch.randn(3, 4)
    (out, fed), new_state = fp(state, {"x": xs})
    torch.testing.assert_close(out, xs @ scope.get("fc_0.w_0"))
    assert fed is xs
    assert int(new_state["count"][0]) == 1 and int(state["count"][0]) == 0
    state_to_scope(new_state, scope)
    assert int(scope.get("count")[0]) == 1
    assert scope.get("count").dtype == torch.int32


# -- devices -----------------------------------------------------------------

def test_decoder_defaults_to_the_card(trained):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default place is valid")
    from paddle_tpu_torch.jit import FunctionalProgram

    prog, _, logits, pairs = ptp.build_transformer_cached_step_program(
        B, T, V, n_layer=L, n_head=H, d_model=D)
    scope = Scope()
    io.params_from_numpy(scope, trained, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        fluid.ProgramDecoder(prog, token_name="tok",
                             logits_name=logits.name, state_pairs=pairs,
                             scope=scope)
    with pytest.raises(RuntimeError, match="CUDA"):
        FunctionalProgram(prog, ["tok"], [logits.name])
