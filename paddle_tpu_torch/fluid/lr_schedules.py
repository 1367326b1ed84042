"""Learning-rate schedules as ops of the program.

Counterpart of paddle_tpu/fluid/lr_schedules.py (reference:
paddle/parameter/LearningRateScheduler.cpp's poly, exp, discexp and
linear schedules; later fluid's layers.exponential_decay and the
rest).  Each schedule owns a persistable step counter, int64 (it runs
as int32, as every int64 var does), which an in-place `increment`
advances at the top of every run, so the first step computes with step
1; the step's rate comes from elementwise ops on it.  Pass the
returned Variable as any optimizer's `learning_rate`:

    lr = fluid.lr_schedules.exponential_decay(0.1, decay_steps=100,
                                              decay_rate=0.5)
    fluid.optimizer.SGD(learning_rate=lr).minimize(loss)

The programs equal the JAX package's through `to_dict()`.
"""

from .framework import unique_name
from .initializer import Constant
from .layer_helper import LayerHelper
from .layers import tensor as tensor_layers

__all__ = ["exponential_decay", "natural_exp_decay",
           "inverse_time_decay", "polynomial_decay", "piecewise_decay",
           "v2_schedule"]


def _helper():
    return LayerHelper("lr_schedule")


def _op(helper, type, inputs, attrs=None):
    out = helper.create_tmp_variable("float32", stop_gradient=True)
    helper.append_op(type=type, inputs=inputs, outputs={"Out": [out]},
                     attrs=attrs or {})
    return out


def _const(value):
    return tensor_layers.fill_constant(shape=[1], dtype="float32",
                                       value=float(value))


def _step_counter(helper):
    """The step, as f32, of a persistable integer counter (an f32 one
    would stop advancing at 2^24 steps) that starts at 0 and is advanced
    in place before it is read."""
    counter = helper.create_variable(
        name=unique_name("lr_sched_step"), persistable=True, dtype="int64",
        shape=[1])
    helper.set_variable_initializer(counter, Constant(0))
    tensor_layers.increment(counter, value=1, in_place=True)
    return tensor_layers.cast(counter, "float32")


def _ratio(helper, step, decay_steps, staircase):
    # an exact division: a f32 reciprocal lands floor and ceil on the
    # wrong side of exact multiples for many decay_steps
    r = _op(helper, "elementwise_div",
            {"X": [step], "Y": [_const(decay_steps)]})
    if staircase:
        r = _op(helper, "floor", {"X": [r]})
    return r


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr * decay_rate ** (step / decay_steps)."""
    helper = _helper()
    step = _step_counter(helper)
    exponent = _ratio(helper, step, decay_steps, staircase)
    factor = _op(helper, "elementwise_pow",
                 {"X": [_const(decay_rate)], "Y": [exponent]})
    return _op(helper, "scale", {"X": [factor]},
               {"scale": float(learning_rate)})


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr * exp(-decay_rate * step / decay_steps)."""
    helper = _helper()
    step = _step_counter(helper)
    r = _ratio(helper, step, decay_steps, staircase)
    neg = _op(helper, "scale", {"X": [r]}, {"scale": -float(decay_rate)})
    factor = _op(helper, "exp", {"X": [neg]})
    return _op(helper, "scale", {"X": [factor]},
               {"scale": float(learning_rate)})


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """lr / (1 + decay_rate * step / decay_steps)."""
    helper = _helper()
    step = _step_counter(helper)
    r = _ratio(helper, step, decay_steps, staircase)
    scaled = _op(helper, "scale", {"X": [r]}, {"scale": float(decay_rate)})
    denom = _op(helper, "elementwise_add",
                {"X": [scaled], "Y": [_const(1.0)]})
    return _op(helper, "elementwise_div",
               {"X": [_const(learning_rate)], "Y": [denom]})


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=1e-4,
                     power=1.0, cycle=False):
    """(lr - end) * (1 - min(step, N) / N) ** power + end; with `cycle`
    the horizon N stretches to ceil(step / N) * N (at least N)."""
    helper = _helper()
    step = _step_counter(helper)
    n = _const(decay_steps)
    if cycle:
        cycles = _op(helper, "ceil", {"X": [
            _op(helper, "elementwise_div",
                {"X": [step], "Y": [_const(decay_steps)]})]})
        cycles = _op(helper, "elementwise_max",
                     {"X": [cycles], "Y": [_const(1.0)]})
        n = _op(helper, "elementwise_mul", {"X": [cycles], "Y": [n]})
    capped = _op(helper, "elementwise_min", {"X": [step], "Y": [n]})
    frac = _op(helper, "elementwise_sub", {
        "X": [_const(1.0)],
        "Y": [_op(helper, "elementwise_div", {"X": [capped], "Y": [n]})]})
    poly = _op(helper, "elementwise_pow", {"X": [frac], "Y": [_const(power)]})
    span = _op(helper, "scale", {"X": [poly]},
               {"scale": float(learning_rate) - float(end_learning_rate)})
    return _op(helper, "elementwise_add",
               {"X": [span], "Y": [_const(end_learning_rate)]})


def v2_schedule(name, learning_rate, decay_a=0.0, decay_b=0.0,
                batch_size=1):
    """The reference trainer's schedules by samples processed, n = step
    * batch_size (LearningRateScheduler.cpp, `settings(
    learning_rate_schedule=..., learning_rate_decay_a=a,
    learning_rate_decay_b=b)`):

      poly:     lr * (1 + a n) ** (-b)
      exp:      lr * a ** (n / b)
      discexp:  lr * a ** floor(n / b)
      linear:   max(lr - a n, b)
      constant: lr (a float, no ops)
    """
    if name == "constant":
        return float(learning_rate)
    helper = _helper()
    step = _step_counter(helper)
    n = _op(helper, "scale", {"X": [step]}, {"scale": float(batch_size)})
    if name == "poly":
        base = _op(helper, "elementwise_add",
                   {"X": [_const(1.0)],
                    "Y": [_op(helper, "scale", {"X": [n]},
                              {"scale": float(decay_a)})]})
        factor = _op(helper, "elementwise_pow",
                     {"X": [base], "Y": [_const(-float(decay_b))]})
        return _op(helper, "scale", {"X": [factor]},
                   {"scale": float(learning_rate)})
    if name in ("exp", "discexp"):
        if float(decay_b) <= 0:
            raise ValueError(
                "%s schedule needs learning_rate_decay_b > 0 (the "
                "samples-per-decay horizon); got %r" % (name, decay_b))
        ratio = _ratio(helper, n, decay_b, staircase=(name == "discexp"))
        factor = _op(helper, "elementwise_pow",
                     {"X": [_const(decay_a)], "Y": [ratio]})
        return _op(helper, "scale", {"X": [factor]},
                   {"scale": float(learning_rate)})
    if name == "linear":
        dropped = _op(helper, "elementwise_sub",
                      {"X": [_const(learning_rate)],
                       "Y": [_op(helper, "scale", {"X": [n]},
                                 {"scale": float(decay_a)})]})
        return _op(helper, "elementwise_max",
                   {"X": [dropped], "Y": [_const(decay_b)]})
    raise ValueError("unknown learning_rate_schedule %r" % name)


def piecewise_decay(boundaries, values):
    """values[i] while step < boundaries[i], values[-1] from the last
    boundary on: the sum over the segments of an indicator times the
    segment's value."""
    if len(values) != len(boundaries) + 1:
        raise ValueError("need len(values) == len(boundaries) + 1")
    if any(b2 <= b1 for b1, b2 in zip(boundaries, boundaries[1:])):
        raise ValueError("boundaries must be strictly increasing, "
                         "got %r" % (boundaries,))
    helper = _helper()
    step = _step_counter(helper)
    lr = _const(0.0)
    prev_bound = None
    for i, v in enumerate(values):
        below = None
        if i < len(boundaries):
            below = tensor_layers.cast(
                _op(helper, "less_than",
                    {"X": [step], "Y": [_const(boundaries[i])]}),
                "float32")
        if prev_bound is None:
            ind = below if below is not None else _const(1.0)
        else:
            at_or_after = _op(helper, "elementwise_sub",
                              {"X": [_const(1.0)], "Y": [prev_bound]})
            ind = at_or_after if below is None else _op(
                helper, "elementwise_mul",
                {"X": [at_or_after], "Y": [below]})
        term = _op(helper, "scale", {"X": [ind]}, {"scale": float(v)})
        lr = _op(helper, "elementwise_add", {"X": [lr], "Y": [term]})
        if below is not None:
            prev_bound = below
    return lr
