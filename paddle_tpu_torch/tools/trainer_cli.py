"""paddle_trainer-style CLI: train a config-file topology.

reference: paddle/trainer/TrainerMain.cpp:32 (`paddle_trainer
--config=conf.py --num_passes=.. --save_dir=..`) — the C++ trainer
embeds Python to parse the config and drives GradientMachine passes.
Here the config executes directly (its DSL calls build the fluid
Program), and the v2 SGD trainer drives the program:

    python -m paddle_tpu_torch.tools.trainer_cli --config=conf.py \
        --num_passes=3 --save_dir=./output [--use_gpu=1]

Counterpart of paddle_tpu/tools/trainer_cli.py, with the same flags.
`--use_gpu` (default 1) trains on CUDAPlace(0) through
`v2.init(use_gpu=...)`, which raises without a CUDA device; `--use_gpu=0`
trains on the CPU (the JAX CLI ignores the flag).  A config for the port
imports `paddle_tpu_torch.trainer_config_helpers` and names its data
provider in the port's package; the config calls settings(...),
define_py_data_sources2(...), builds layers, and declares outputs(cost)
(trainer_config_helpers/config.py has the provider convention).
"""

import argparse
import os
import runpy
import sys

import numpy as np

from . import use_gpu_arg


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="paddle_trainer")
    p.add_argument("--config", required=True,
                   help="python config file (trainer_config_helpers DSL)")
    p.add_argument("--num_passes", type=int, default=1)
    p.add_argument("--save_dir", default=None,
                   help="save parameters tar per pass (ParamUtil "
                        "behavior: pass-00000/, pass-00001/, ...)")
    p.add_argument("--init_model_path", default=None,
                   help="warm-start parameters tar")
    p.add_argument("--start_pass", type=int, default=0)
    p.add_argument("--log_period", type=int, default=10)
    p.add_argument("--use_gpu", type=use_gpu_arg, default=True,
                   help="1 (default): train on CUDAPlace(0); 0: on the "
                        "CPU")
    p.add_argument("--trainer_count", type=int, default=1,
                   help="accepted for compat; the trainer runs one "
                        "device")
    return p.parse_args(argv)


def main(argv=None):
    """Train the config's topology in programs and a scope of its own,
    so that one process may call main more than once."""
    from .. import fluid

    with fluid.program_guard(fluid.Program(), fluid.Program()), \
            fluid.scope_guard(fluid.Scope()):
        return _train(parse_args(argv))


def _train(args):
    from .. import reader as reader_mod
    from .. import v2
    from ..trainer_config_helpers import config as tc_config

    v2.init(use_gpu=args.use_gpu, trainer_count=args.trainer_count)
    cfg = tc_config.reset_config()
    # execute the config: its DSL calls build into the default Program
    # and record settings/outputs/data sources
    sys.path.insert(0, os.path.dirname(os.path.abspath(args.config)))
    runpy.run_path(args.config, run_name="__paddle_config__")

    if not cfg.outputs:
        raise SystemExit("config declared no outputs(); nothing to train")
    cost = cfg.outputs[0]
    train_reader = tc_config.build_reader(cfg.train_source)
    if train_reader is None:
        raise SystemExit("config declared no train data source")
    test_reader = tc_config.build_reader(cfg.test_source)

    optimizer = cfg.learning_method or v2.optimizer.Adam(
        learning_rate=cfg.learning_rate)
    if cfg.lr_explicit:
        # reference DSL semantics: settings() owns the learning rate,
        # the learning_method object only picks the update rule
        optimizer.learning_rate = cfg.learning_rate
    schedule = cfg.extra.get("learning_rate_schedule")
    if schedule and schedule != "constant":
        # reference LearningRateScheduler spellings (samples-based)
        from .. import fluid

        optimizer.learning_rate = fluid.lr_schedules.v2_schedule(
            schedule, optimizer.learning_rate,
            decay_a=float(cfg.extra.get("learning_rate_decay_a", 0.0)),
            decay_b=float(cfg.extra.get("learning_rate_decay_b", 0.0)),
            batch_size=cfg.batch_size)

    parameters = v2.parameters.create(cost)
    if args.init_model_path:
        with open(args.init_model_path, "rb") as f:
            parameters.init_from_tar(f)
    trainer = v2.trainer.SGD(cost=cost, parameters=parameters,
                             update_equation=optimizer)

    batched = reader_mod.batch(train_reader, batch_size=cfg.batch_size)
    state = {"pass": args.start_pass, "batch": 0, "costs": []}

    def handler(ev):
        if isinstance(ev, v2.event.EndIteration):
            state["batch"] += 1
            state["costs"].append(float(np.asarray(ev.cost).reshape(-1)[0]))
            if state["batch"] % args.log_period == 0:
                print("Pass %d, Batch %d, Cost %.6f" %
                      (state["pass"], state["batch"], state["costs"][-1]),
                      flush=True)
        elif isinstance(ev, v2.event.EndPass):
            mean_cost = (float(np.mean(state["costs"]))
                         if state["costs"] else float("nan"))
            line = "Pass %d done, AvgCost %.6f" % (state["pass"],
                                                   mean_cost)
            if test_reader is not None:
                result = trainer.test(reader=reader_mod.batch(
                    test_reader, batch_size=cfg.batch_size))
                line += ", TestCost %.6f" % result.cost
            print(line, flush=True)
            if args.save_dir:
                pass_dir = os.path.join(args.save_dir,
                                        "pass-%05d" % state["pass"])
                os.makedirs(pass_dir, exist_ok=True)
                with open(os.path.join(pass_dir, "params.tar"),
                          "wb") as f:
                    parameters.to_tar(f)
            state["pass"] += 1
            state["batch"] = 0
            state["costs"] = []

    trainer.train(reader=batched, num_passes=args.num_passes,
                  event_handler=handler)
    return 0


if __name__ == "__main__":
    sys.exit(main())
