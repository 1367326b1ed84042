"""Config-file protocol for the paddle_trainer-style CLI.

Counterpart of paddle_tpu/trainer_config_helpers/config.py.

The reference CLI (`paddle train --config=conf.py`, reference:
paddle/trainer/TrainerMain.cpp:32 + trainer/config_parser.py) embeds
Python to evaluate a config script that calls `settings(...)`,
`define_py_data_sources2(...)`, builds layers, and declares
`outputs(cost)`; the trainer then drives that topology.  Here the same
three calls record into a per-process config registry that
`paddle_tpu_torch.tools.trainer_cli` consumes — the topology itself is
the default fluid Program the DSL layers already build into.

Data-provider convention (replaces the reference's @provider
decorators): `module.obj` must be a callable
`obj(file_list, **(args or {})) -> reader`, where reader() yields
sample tuples in data-layer declaration order.
"""

import importlib

__all__ = ["settings", "outputs", "define_py_data_sources2",
           "get_config", "reset_config"]


class TrainerConfig:
    def __init__(self):
        self.batch_size = 32
        self.learning_rate = 1e-3
        self.lr_explicit = False        # settings() gave learning_rate
        self.learning_method = None     # v2 optimizer object
        self.outputs = []               # declared output/cost layers
        self.train_source = None        # (file_list, module, obj, args)
        self.test_source = None
        self.extra = {}                 # unrecognized settings() kwargs


_config = TrainerConfig()


def get_config():
    return _config


def reset_config():
    global _config
    _config = TrainerConfig()
    return _config


def settings(batch_size=None, learning_rate=None, learning_method=None,
             **kwargs):
    """reference: trainer_config_helpers/optimizers.py settings — batch
    size, learning rate, and the optimization method for the run."""
    if batch_size is not None:
        _config.batch_size = int(batch_size)
    if learning_rate is not None:
        _config.learning_rate = float(learning_rate)
        _config.lr_explicit = True
    if learning_method is not None:
        _config.learning_method = learning_method
    _config.extra.update(kwargs)


def outputs(*layers):
    """Declare the topology's output layers; training uses the first as
    the cost (reference: config_parser outputs())."""
    _config.outputs = [l for group in layers
                       for l in (group if isinstance(group, (list, tuple))
                                 else [group])]


def define_py_data_sources2(train_list, test_list, module, obj,
                            args=None):
    """Register train/test data providers (reference:
    trainer_config_helpers/data_sources.py:158).  `module`/`obj` may
    each be a single name or a (train, test) pair."""
    def pick(v, idx):
        return v[idx] if isinstance(v, (list, tuple)) else v

    if train_list is not None:
        _config.train_source = (train_list, pick(module, 0),
                                pick(obj, 0), pick(args, 0))
    if test_list is not None:
        _config.test_source = (test_list, pick(module, 1),
                               pick(obj, 1), pick(args, 1))


def build_reader(source):
    """(file_list, module, obj, args) -> reader callable."""
    if source is None:
        return None
    file_list, module, obj, args = source
    mod = importlib.import_module(module)
    provider = getattr(mod, obj)
    return provider(file_list, **(args or {}))
