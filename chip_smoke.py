#!/usr/bin/env python3
"""Drive the paddle_tpu_torch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printing its lines; any failure exits non-zero and prints
no result line:
  1. device: the card's name and power limit (fails without CUDA);
  2. build: every CUDA kernel of the package, from csrc/, with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the served shapes and at edge cases, with kernel, plain and
     library times and the bound of the same work on this card;
  4. slice: the full-width transformer (batch 16, seq 512, d_model 512,
     6 layers, 8 heads, vocab 8192, random weights from a seed) exported,
     loaded by InferenceEngine on the card and served by InferenceServer:
     3 concurrent POST /v1/infer of one row each, then one 16-row
     engine.run.  Launch counters, reset just before, show the path went
     through the kernels; the logits are checked against the port's plain
     path on the CPU.
The last line is {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the paddle_tpu package.
"""

import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

SEED = 0
# the served model: bench.py's BENCH_MODEL=transformer configuration
BATCH, SEQ, D_MODEL, N_LAYER, N_HEAD, VOCAB = 16, 512, 512, 6, 8, 8192
BUCKETS = [1, 2, 4, 8, 16]

# H100 SXM peaks (NVIDIA data sheet, dense, at a 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12,     # f32 outside the tensor cores
              "bfloat16": 989e12}   # bf16 tensor cores

# kernel against plain version: (O atol, m atol, l rtol) by dtype.  Both
# compute the same f32 sums in other orders (the kernel in 16-key chunks,
# the plain version in 128-key tiles); bf16 O also rounds p and O to bf16
# at points that differ by a chunk, up to an ulp of bf16 (2^-8 relative).
TOL = {"float32": (2e-5, 1e-4, 1e-4), "bfloat16": (2e-2, 1e-4, 1e-4)}
# served logits, card against the port's plain CPU path: float32 on both
# sides, sums in other orders (cuBLAS and the CUDA kernel against CPU BLAS
# and the plain attention) through 6 layers of reductions up to 2048 long
LOGITS_ATOL = 2e-3


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warm=3):
    """Mean milliseconds of fn() on the card, by CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(B, H, Tq, Tk, D, causal, q_offset, dtype):
    """(ms, "bytes" | "operations"): the least time the card needs for
    the attention forward on these inputs — q, k, v read once, o, m, l
    written once, and 4*D operations per (query, key) pair this run's
    mask keeps."""
    itemsize = 2 if dtype == "bfloat16" else 4
    if causal:
        keys = np.clip(q_offset + np.arange(Tq) + 1, 0, Tk).sum()
    else:
        keys = Tq * Tk
    flops = 4.0 * D * B * H * float(keys)
    nbytes = B * H * ((2 * Tq + 2 * Tk) * D * itemsize + 2 * Tq * 4)
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    print("device: %s, count %d, torch %s, cuda %s"
          % (torch.cuda.get_device_name(0), torch.cuda.device_count(),
             torch.__version__, torch.version.cuda), flush=True)
    print("nvidia-smi: %s" % nvidia_smi_line(), flush=True)


def phase_build():
    from paddle_tpu_torch.kernels import _build

    seconds = _build.build_all()
    print("build: %d kernel libraries in %.1f s"
          % (len(_build.SOURCES), seconds), flush=True)
    for name in _build.SOURCES:
        log = _build.build_log(name) or "(already built)"
        print("build %s:\n%s" % (name, log.strip()), flush=True)


def phase_kernels():
    """The flash-attention kernel against its plain version; returns the
    path-shape f32 numbers for the kernels line."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    B, H, T, D = BATCH, N_HEAD, SEQ, D_MODEL // N_HEAD
    cases = [  # name, T, dtype, causal, q_offset
        ("path f32 causal", T, "float32", True, 0),
        ("path bf16 causal", T, "bfloat16", True, 0),
        ("path f32 non-causal", T, "float32", False, 0),
        ("path f32 causal q_offset=64", T, "float32", True, 64),
        ("T=200 f32 causal", 200, "float32", True, 0),
    ]
    path = None
    for name, t, dtype, causal, q_offset in cases:
        tdt = getattr(torch, dtype)
        q, k, v = [torch.randn(B, H, t, D, device="cuda", generator=gen)
                   .to(tdt) for _ in range(3)]
        scale = D ** -0.5
        o, m, l = fa.flash_attention_fwd(q, k, v, scale, causal,
                                         q_offset=q_offset)
        po, pm, pl = fa.flash_attention_plain(q, k, v, scale, causal,
                                              q_offset=q_offset)
        torch.cuda.synchronize()
        err_o = (o.float() - po.float()).abs().max().item()
        err_m = (m - pm).abs().max().item()
        err_l = ((l - pl).abs() / pl.abs().clamp_min(1e-30)).max().item()
        tol_o, tol_m, tol_l = TOL[dtype]
        ok = err_o <= tol_o and err_m <= tol_m and err_l <= tol_l \
            and bool(torch.isfinite(o.float()).all())
        k_ms = cuda_ms(lambda: fa.flash_attention_fwd(
            q, k, v, scale, causal, q_offset=q_offset))
        p_ms = cuda_ms(lambda: fa.flash_attention_plain(
            q, k, v, scale, causal, q_offset=q_offset), iters=5)
        bound_ms, bound_by = attention_bound(B, H, t, t, D, causal,
                                             q_offset, dtype)
        print("kernel flash_attention_fwd [%s] %s: max_abs_err O %.3g "
              "(atol %g) m %.3g (atol %g) l rel %.3g (rtol %g); kernel "
              "%.4f ms, plain %.4f ms, bound %.4f ms (%s)"
              % (name, list(q.shape), err_o, tol_o, err_m, tol_m, err_l,
                 tol_l, k_ms, p_ms, bound_ms, bound_by), flush=True)
        if not ok:
            raise SystemExit("chip_smoke: flash_attention_fwd disagrees "
                             "with its plain version on %s" % name)
        if path is None:
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale))
            print("library scaled_dot_product_attention [%s]: %.4f ms"
                  % (name, lib_ms), flush=True)
            path = {"max_abs_err": err_o, "ms": k_ms, "plain_ms": p_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": lib_ms}
        del q, k, v, o, m, l, po, pm, pl
    from paddle_tpu_torch.kernels import KERNELS

    print("kernels: %s" % json.dumps(
        {n: w.launches for n, w in KERNELS.items()}), flush=True)
    return {"flash_attention_fwd": path}


def _post(url, payload):
    t0 = time.perf_counter()
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        status = resp.status
        body = json.loads(resp.read())
    return status, body, (time.perf_counter() - t0) * 1e3


def profile_forward(forward, runs=3):
    """Device time by kernel over `runs` 16-row forwards, from
    torch.profiler's CUDA activity: the busy share of the wall window and
    the kernels that take the most time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            forward()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(k[1] for k in kernels)
    if not kernels:
        print("profile: the profiler recorded no device time (not "
              "measured)", flush=True)
        return
    print("profile: %d forwards, wall %.3f ms, device busy %.3f ms (%.1f "
          "%%)" % (runs, wall_us / 1e3, busy_us / 1e3,
                   100.0 * busy_us / wall_us), flush=True)
    for name, us, count in sorted(kernels, key=lambda k: -k[1])[:10]:
        print("profile: %6.1f %% %9.3f ms per forward  %4d launches  %s"
              % (100.0 * us / busy_us, us / 1e3 / runs, count,
                 name[:110]), flush=True)


def phase_slice():
    """Serve the full-width transformer; returns the launch counts of
    this run."""
    import torch
    from paddle_tpu_torch.fluid import CPUPlace, Scope, io
    from paddle_tpu_torch.kernels import KERNELS
    from paddle_tpu_torch.models import transformer_program as tp
    from paddle_tpu_torch.serving import (EngineConfig, InferenceEngine,
                                          InferenceServer, ServerConfig)

    fa_fwd = KERNELS["flash_attention_fwd"]
    logits = tp.logits_name(N_LAYER)
    feeds = tp.transformer_feeds(BATCH, SEQ, VOCAB, seed=SEED)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        prog = tp.build_transformer_inference_program(
            BATCH, SEQ, VOCAB, n_layer=N_LAYER, n_head=N_HEAD,
            d_model=D_MODEL)
        params = tp.init_transformer_params(prog, seed=SEED)
        scope = Scope()
        io.params_from_numpy(scope, params, "cpu")
        io.save_inference_model(tmp, ["tokens", "positions"], [logits],
                                scope, prog,
                                bucket_hints={"batch_buckets": BUCKETS})
        n_params = sum(p.size for p in params.values())
        print("slice: %d ops, %d parameters, exported in %.1f s"
              % (len(prog.block(0).ops), n_params,
                 time.perf_counter() - t0), flush=True)

        engine = InferenceEngine.from_saved_model(tmp)
        if engine.place.device().type != "cuda":
            raise SystemExit("chip_smoke: the engine is not on the card")
        server = InferenceServer(engine, ServerConfig(
            port=0, max_batch=BATCH, max_wait_ms=50.0, warmup=True))
        for w in KERNELS.values():
            w.launches = 0
        forwards = 0
        try:
            t0 = time.perf_counter()
            server.start()
            forwards += len(BUCKETS)
            print("slice: server up with warmup of %d buckets in %.2f s"
                  % (len(BUCKETS), time.perf_counter() - t0), flush=True)
            if fa_fwd.launches != 6 * forwards:
                raise SystemExit("chip_smoke: %d flash launches after %d "
                                 "warmup forwards" % (fa_fwd.launches,
                                                      forwards))
            host, port = server.address
            url = "http://%s:%d/v1/infer" % (host, port)
            replies = [None] * 3

            def client(i):
                replies[i] = _post(url, {"inputs": {
                    n: v[i:i + 1].tolist() for n, v in feeds.items()}})

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(3)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=900)
            if any(r is None for r in replies):
                raise SystemExit("chip_smoke: an HTTP request got no reply")
            batches = server.metrics.batch_occupancy.count
            forwards += batches
            print("slice: 3 requests answered in %d batch(es); latencies "
                  "%s ms" % (batches, ", ".join(
                      "%.1f" % r[2] for r in replies)), flush=True)
            if fa_fwd.launches != 6 * forwards:
                raise SystemExit("chip_smoke: %d flash launches after %d "
                                 "forwards" % (fa_fwd.launches, forwards))
            out16 = engine.run(feeds)[0]
            forwards += 1
            # the main path ends here: read the counts
            launches = {n: w.launches for n, w in KERNELS.items()}
            if launches["flash_attention_fwd"] != 6 * forwards:
                raise SystemExit("chip_smoke: %d flash launches after %d "
                                 "forwards" % (fa_fwd.launches, forwards))
            print("slice: main path ran %d forwards, launches %s"
                  % (forwards, json.dumps(launches)), flush=True)

            # forward time of the 16-row batch on the card (feeds already
            # on the device, logits left there)
            dev = engine.place.device()
            dev_feeds = {n: torch.from_numpy(v.astype(np.int32)).to(dev)
                         for n, v in feeds.items()}

            def forward():
                return engine._exe.run(engine.program, feed=dev_feeds,
                                       fetch_list=[logits],
                                       scope=engine.scope,
                                       return_numpy=False)

            for _ in range(2):
                forward()
            torch.cuda.synchronize()
            times = []
            for _ in range(10):
                t0 = time.perf_counter()
                forward()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            run_times = []
            for _ in range(3):
                t0 = time.perf_counter()
                engine.run(feeds)
                run_times.append((time.perf_counter() - t0) * 1e3)
            print("slice: 16-row forward %.3f ms (mean of 10 after 2 warm; "
                  "median %.3f, min %.3f, max %.3f); engine.run of 16 rows "
                  "with the logits copied to the host %.1f ms (mean of 3)"
                  % (np.mean(times), np.median(times), min(times),
                     max(times), np.mean(run_times)), flush=True)
            profile_forward(forward)
        finally:
            server.shutdown()

        # the port's plain path on the CPU, same export, rows 0..2
        t0 = time.perf_counter()
        cpu = InferenceEngine.from_saved_model(
            tmp, place=CPUPlace(), config=EngineConfig(batch_buckets=None))
        ref = cpu.run({n: v[:3] for n, v in feeds.items()})[0]
        print("slice: CPU reference of 3 rows in %.1f s"
              % (time.perf_counter() - t0), flush=True)

    errs = []
    for i, (status, body, _) in enumerate(replies):
        if status != 200:
            raise SystemExit("chip_smoke: HTTP %d: %s" % (status, body))
        got = np.asarray(body["outputs"][logits], np.float32)
        if got.shape != (1, SEQ, VOCAB):
            raise SystemExit("chip_smoke: reply logits shape %s"
                             % (got.shape,))
        errs.append(float(np.abs(got[0] - ref[i]).max()))
    if out16.shape != (BATCH, SEQ, VOCAB) or not np.isfinite(out16).all():
        raise SystemExit("chip_smoke: 16-row logits %s, finite %s"
                         % (out16.shape, np.isfinite(out16).all()))
    errs.append(float(np.abs(out16[:2] - ref[:2]).max()))
    print("slice: logits max_abs_err against the CPU plain path: HTTP "
          "rows %s, engine.run rows 0-1 %.3g (atol %g)"
          % (", ".join("%.3g" % e for e in errs[:3]), errs[3],
             LOGITS_ATOL), flush=True)
    if max(errs) > LOGITS_ATOL:
        raise SystemExit("chip_smoke: served logits disagree with the CPU "
                         "plain path")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    measured = phase_kernels()
    launches = phase_slice()
    from paddle_tpu_torch.kernels import KERNELS

    from paddle_tpu_torch.kernels._build import SOURCES

    kernels = []
    # the TPU kernel each one ports: file:line of the Pallas kernel body
    replaces = {"flash_attention_fwd":
                "paddle_tpu/kernels/flash_attention.py:27"}
    for name in KERNELS:
        if launches[name] < 1:
            raise SystemExit("chip_smoke: %s was never launched on the "
                             "main path" % name)
        source = "paddle_tpu_torch/csrc/" + SOURCES[name]
        kernels.append(dict({"name": name, "route": "cuda",
                             "source": source, "replaces": replaces[name],
                             "launches": launches[name]}, **measured[name]))
    print(json.dumps({"kernels": kernels}))
    print("chip_smoke: all phases passed in %.1f s"
          % (time.perf_counter() - t_start))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
