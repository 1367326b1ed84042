"""Automatic mixed precision: bf16 compute, f32 master weights.

Counterpart of paddle_tpu/fluid/amp.py (`enable_bf16`, `disable_bf16`,
`bf16_enabled`, `bf16_guard`, `LossScaler`).  While `amp_bf16` is on,
`mul` and `conv2d` run their products in bf16 (tensor cores on the
card) and, with `amp_bf16_act` (the default), their results and the
elementwise, relu, pool and batch-norm chains after them stay bf16;
parameters, optimizer state, batch statistics and losses stay f32
(ops/amp_util.py).
The flag is read as the kernels run: a program built in f32 trains in
bf16 when its `Executor.run` calls are made under `bf16_guard()`.
"""

import contextlib

from ..utils import flags

__all__ = ["enable_bf16", "disable_bf16", "bf16_enabled", "bf16_guard",
           "LossScaler"]


class LossScaler:
    """Dynamic loss scaling with a health-signal surface.

    bf16 keeps f32's exponent range, so the AMP path needs no scaling:
    this exists for float16-style flows and as the `amp_loss_scale`
    health gauge: `update(found_nonfinite)` backs off on overflow and
    grows after `growth_interval` clean steps, and every update
    publishes the current scale into the unified registry
    (`obs.health.NumericsMonitor(loss_scaler=...)` drives it from the
    on-device nonfinite counts)."""

    def __init__(self, init_scale=2.0 ** 15, growth_factor=2.0,
                 backoff_factor=0.5, growth_interval=1000,
                 min_scale=1.0, max_scale=2.0 ** 24):
        if init_scale <= 0:
            raise ValueError("init_scale must be positive")
        self._scale = float(init_scale)
        self.growth_factor = float(growth_factor)
        self.backoff_factor = float(backoff_factor)
        self.growth_interval = int(growth_interval)
        self.min_scale = float(min_scale)
        self.max_scale = float(max_scale)
        self._good_steps = 0
        self._publish()

    def _publish(self):
        from ..obs import telemetry as obs_tele

        obs_tele.set_gauge("amp_loss_scale", self._scale)

    @property
    def scale(self):
        return self._scale

    def set_scale(self, value):
        """Restore the scale directly (a checkpoint resume); clamps to
        [min_scale, max_scale], resets the clean-step streak, and
        republishes the gauge."""
        self._scale = min(self.max_scale,
                          max(self.min_scale, float(value)))
        self._good_steps = 0
        self._publish()
        return self._scale

    def update(self, found_nonfinite):
        """One step's verdict: overflow halves the scale (and the step
        should be skipped by the caller), a clean streak of
        `growth_interval` steps doubles it.  Returns the new scale."""
        if found_nonfinite:
            self._scale = max(self.min_scale,
                              self._scale * self.backoff_factor)
            self._good_steps = 0
        else:
            self._good_steps += 1
            if self._good_steps >= self.growth_interval:
                self._scale = min(self.max_scale,
                                  self._scale * self.growth_factor)
                self._good_steps = 0
        self._publish()
        return self._scale


def enable_bf16():
    flags.set_flag("amp_bf16", True)


def disable_bf16():
    flags.set_flag("amp_bf16", False)


def bf16_enabled():
    return flags.get_flag("amp_bf16")


@contextlib.contextmanager
def bf16_guard():
    prev = bf16_enabled()
    flags.set_flag("amp_bf16", True)
    try:
        yield
    finally:
        flags.set_flag("amp_bf16", prev)
