#!/usr/bin/env python3
"""The cost of the port's fixed-order row sums on one NVIDIA GPU.

    python3 scripts/torch_repeat_cost.py        # from a checkout's root

Times, with the `paddle_tpu_torch` and `chip_smoke.py` of the checkout
it runs from (the working directory), the places whose rows of a
repeated id are summed: the CTR DeepFM's Adam step at 10,000,000
features (median of 10 after 2 warm, feeds on the card), `sgd`'s row
update alone on its [10,000,000, 16] table with one batch's
SelectedRows grad (device ms by CUDA graph replay), the dense
`lookup_table_grad` alone at the seq2seq's target embedding (batch 128:
[30,000, 32], one id a target token), and the seq2seq's training step
at batch 128 (median of 10 after 2 warm).  Run it from the root of two
checkouts in turns (parent, change, change, parent) in one session on
one card to compare them.  Prints one JSON object a line.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.getcwd())

import chip_smoke as c  # noqa: E402


def ctr_adam_step(exe):
    """The Adam step at CTR_BIG_FEATURES: median ms."""
    import paddle_tpu_torch.fluid as fluid

    batch = next(c.ctr_reader(c.CTR_BIG_FEATURES))
    feed = c.ctr_feed(batch, exe.device)
    main, startup, loss, _, _ = c.build_ctr(c.CTR_BIG_FEATURES, "Adam")
    scope = fluid.Scope()
    exe.run(startup, scope=scope)

    def step():
        return exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)

    return float(np.median(c.timed_steps(step)))


def sgd_update(exe):
    """`sgd` alone on the [CTR_BIG_FEATURES, 16] table: device ms."""
    import paddle_tpu_torch.fluid as fluid

    batch = next(c.ctr_reader(c.CTR_BIG_FEATURES))
    main, startup, _, _, _ = c.build_ctr(c.CTR_BIG_FEATURES, "SGD")
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    ms, bound, _ = c.ctr_op_times(scope, "SGD", batch, c.CTR_BIG_FEATURES)
    return ms, bound


def lookup_grad(exe):
    """The dense lookup_table_grad at the seq2seq's target embedding,
    batch 128: device ms."""
    import torch
    from paddle_tpu_torch.ops.registry import get_op_info

    b = c.s2s_batches(c.S2S_DICT, 128, 1)[0]
    ids = np.concatenate([np.asarray(s[1]) for s in b]).astype(np.int32)
    dev = exe.device
    gen = torch.Generator(device=dev).manual_seed(c.SEED)
    w = torch.randn(c.S2S_DICT, c.S2S_EMB, device=dev, generator=gen)
    og = torch.randn(ids.size, c.S2S_EMB, device=dev, generator=gen)
    ins = {"Ids": [torch.from_numpy(ids.reshape(-1, 1)).to(dev)],
           "W": [w], "OG@Out": [og]}
    grad = get_op_info("lookup_table").grad_kernel

    def run():
        with torch.no_grad():
            return grad(None, ins, {"is_sparse": False, "padding_idx": -1})

    return c.device_ms(run, launches=10, replays=5), int(ids.size)


def s2s_step(exe):
    """The seq2seq step at batch 128: median ms."""
    import paddle_tpu_torch.fluid as fluid

    main, startup, loss, _, fvars = c.build_seq2seq(c.S2S_DICT)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = c.s2s_feed(fvars, c.s2s_batches(c.S2S_DICT, 128, 1)[0],
                      exe.device)

    def step():
        return exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)

    return float(np.median(c.timed_steps(step)))


def main():
    import torch
    import paddle_tpu_torch.fluid as fluid

    if not torch.cuda.is_available():
        print("torch_repeat_cost: no CUDA device", file=sys.stderr)
        return 1
    exe = fluid.Executor()
    tree = os.path.basename(os.getcwd())
    smi = c.nvidia_smi_line()
    adam = ctr_adam_step(exe)
    torch.cuda.empty_cache()
    sgd_ms, sgd_bound = sgd_update(exe)
    torch.cuda.empty_cache()
    lk_ms, lk_rows = lookup_grad(exe)
    s2s = s2s_step(exe)
    print(json.dumps({"tree": tree, "card": smi,
                      "ctr_adam_step_ms_1e7": adam,
                      "sgd_update_device_ms_1e7": sgd_ms,
                      "sgd_update_bound_ms_1e7": sgd_bound,
                      "lookup_table_grad_device_ms_s2s128": lk_ms,
                      "lookup_table_grad_rows": lk_rows,
                      "s2s_step_ms_128": s2s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
