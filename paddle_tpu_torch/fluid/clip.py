"""Gradient and error clipping.

Counterpart of paddle_tpu/fluid/clip.py (reference:
python/paddle/v2/fluid/clip.py).  A parameter's `gradient_clip_attr`
(its `ParamAttr`'s `clip` or `gradient_clip`) clips its grad after the
backward and before the regularizers and the update
(`Optimizer.minimize`):

- `GradientClipByValue(max, min=-max)`: one `clip` op;
- `GradientClipByNorm(clip_norm)`: one `clip_by_norm` op;
- `GradientClipByGlobalNorm(clip_norm, group_name)`: every grad of the
  group scaled by clip_norm / max(global norm, clip_norm), the global
  norm the root of the sum of each grad's `squared_l2_norm`.  The
  instance keeps the group's context (`self.context`) between its
  calls, as on the JAX side, so one instance serves every parameter of
  a program.

A Variable's `error_clip` (`ErrorClipByValue`) clips the grad of that
variable in place, by a `clip` op that `error_clip_callback` appends
right after the grad op that writes it (the default callback of
`append_backward`).  Every op and var name comes from `unique_name`, so
the programs equal the JAX package's through `to_dict()`.
"""

from . import framework

__all__ = ["GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "ErrorClipByValue",
           "append_gradient_clip_ops", "append_global_norm",
           "error_clip_callback"]

GRAD_SUFFIX = "@GRAD"


def append_global_norm(block, var_list, squared=False, prefix="global_norm"):
    """Append to `block` the ops of sqrt(sum(||v||^2 for v in var_list))
    and return the norm's Variable; with `squared`, var_list holds each
    tensor's squared norm already."""
    if not var_list:
        raise ValueError("append_global_norm needs at least one var")
    dtype = getattr(var_list[0], "dtype", "float32")
    if squared:
        sq_vars = list(var_list)
    else:
        sq_vars = []
        for v in var_list:
            sq = block.create_var(
                name=framework.unique_name(prefix + "_sq"), dtype=dtype,
                shape=(1,))
            block.append_op(type="squared_l2_norm", inputs={"X": [v]},
                            outputs={"Out": [sq]})
            sq_vars.append(sq)
    gsum = block.create_var(name=framework.unique_name(prefix + "_sumsq"),
                            dtype=dtype, shape=(1,))
    block.append_op(type="sum", inputs={"X": sq_vars},
                    outputs={"Out": [gsum]})
    gnorm = block.create_var(name=framework.unique_name(prefix),
                             dtype=dtype, shape=(1,))
    block.append_op(type="sqrt", inputs={"X": [gsum]},
                    outputs={"Out": [gnorm]})
    return gnorm


class BaseErrorClipAttr:
    def append_clip_op(self, block, grad_name):
        raise NotImplementedError


class ErrorClipByValue(BaseErrorClipAttr):
    """Clip the grad of the variable it is set on into [min, max]."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def append_clip_op(self, block, grad_name):
        block.append_op(type="clip", inputs={"X": [grad_name]},
                        outputs={"Out": [grad_name]},
                        attrs={"min": self.min, "max": self.max})


class BaseGradientClipAttr:
    def process_context(self, context, param, grad):
        pass

    def create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def create_operators(self, param, grad):
        return param, grad


def _clipped_var(grad):
    return grad.block.create_var(
        name=framework.unique_name(grad.name + "_clip"), dtype=grad.dtype,
        shape=grad.shape)


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def create_operators(self, param, grad):
        out = _clipped_var(grad)
        grad.block.append_op(type="clip", inputs={"X": [grad]},
                             outputs={"Out": [out]},
                             attrs={"min": self.min, "max": self.max})
        return param, out


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def create_operators(self, param, grad):
        out = _clipped_var(grad)
        grad.block.append_op(type="clip_by_norm", inputs={"X": [grad]},
                             outputs={"Out": [out]},
                             attrs={"max_norm": self.clip_norm})
        return param, out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Scale the group's grads by clip_norm / max(global norm,
    clip_norm) (reference: clip.py GradientClipByGlobalNorm)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def process_context(self, context, param, grad):
        """Append the grad's squared norm to the group's list."""
        block = grad.block
        sq = block.create_var(name=framework.unique_name(grad.name + "_sq"),
                              dtype=grad.dtype, shape=(1,))
        block.append_op(type="squared_l2_norm", inputs={"X": [grad]},
                        outputs={"Out": [sq]})
        context.setdefault(self.group_name, []).append(sq)
        self.context = context

    def create_operators(self, param, grad):
        """The grad times the group's scale, which the first call builds:
        the global norm, clip(norm, clip_norm, inf), and clip_norm over
        that (never a division by 0; at most 1)."""
        block = grad.block
        group = self.context[self.group_name]
        if not isinstance(group[-1], tuple):
            gnorm = append_global_norm(block, group, squared=True)
            denom = block.create_var(
                name=framework.unique_name("clip_denom"), dtype=grad.dtype,
                shape=(1,))
            block.append_op(type="clip", inputs={"X": [gnorm]},
                            outputs={"Out": [denom]},
                            attrs={"min": self.clip_norm,
                                   "max": float("inf")})
            const = block.create_var(
                name=framework.unique_name("clip_norm_const"),
                dtype=grad.dtype, shape=(1,))
            block.append_op(type="fill_constant", outputs={"Out": [const]},
                            attrs={"shape": [1], "value": self.clip_norm,
                                   "dtype": grad.dtype})
            scale = block.create_var(
                name=framework.unique_name("clip_scale"), dtype=grad.dtype,
                shape=(1,))
            block.append_op(type="elementwise_div",
                            inputs={"X": [const], "Y": [denom]},
                            outputs={"Out": [scale]}, attrs={"axis": -1})
            self.context[self.group_name] = [(scale,)]
        scale = self.context[self.group_name][0][0]
        out = _clipped_var(grad)
        block.append_op(type="elementwise_mul",
                        inputs={"X": [grad], "Y": [scale]},
                        outputs={"Out": [out]}, attrs={"axis": -1})
        return param, out


def append_gradient_clip_ops(param_grad):
    """[(param, clipped grad)] for [(param, grad)], each by its
    parameter's `gradient_clip_attr` (none: the grad as it is), and the
    list of ops (empty, as on the JAX side)."""
    context = {}
    clip_attrs = []
    for p, g in param_grad:
        clip_attr = getattr(p, "gradient_clip_attr", None)
        if clip_attr is None:
            clip_attr = NullGradientClipAttr()
        clip_attrs.append(clip_attr)
        clip_attr.process_context(context=context, param=p, grad=g)
    res = []
    for (p, g), clip_attr in zip(param_grad, clip_attrs):
        res.append((p, g) if g is None
                   else clip_attr.create_operators(param=p, grad=g))
    return res, []


def error_clip_callback(block, context):
    """Append the error clip of each forward var whose grad the block's
    last op writes (reference: clip.py error_clip_callback)."""
    for grad_n in block.desc.ops[-1].output_names():
        if not grad_n.endswith(GRAD_SUFFIX):
            continue
        try:
            fwd_var = block.var_recursive(grad_n[: -len(GRAD_SUFFIX)])
        except ValueError:
            continue
        error_clip = getattr(fwd_var, "error_clip", None)
        if error_clip is not None:
            error_clip.append_clip_op(block, grad_n)
