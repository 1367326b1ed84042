"""Registered update-op kernels applied to parameter dicts.

Counterpart of paddle_tpu/parallel/optim.py.  The pipeline and MoE
schedules hold their parameters as stacked dicts ([stage, ...] /
[expert, ...]) with no Program block to append update ops to, so
`PytreeOptimizer` drives the same declarative update rule a
`fluid.optimizer` instance carries (its op type, state slots, shared
scalars and hyperparameter attrs, fluid/optimizer.py) through the
registered op kernel (ops/optimizer_ops.py), tensor by tensor: one rule
for program ops and for schedule-driven training.  The state lives
beside the params, so the schedules lay it out the same way.
"""

import torch
import torch.utils._pytree as pytree

from ..ops.registry import get_op_info

__all__ = ["PytreeOptimizer"]


def _flatten_like(tree, treedef):
    """The leaves of `tree`, which must have the structure `treedef`."""
    leaves, spec = pytree.tree_flatten(tree)
    if spec != treedef:
        raise ValueError("the tree's structure differs from the params'")
    return leaves


class PytreeOptimizer:
    """Apply a fluid optimizer's update rule over a dict of params.

        opt = PytreeOptimizer(fluid.optimizer.Momentum(0.1, momentum=0.9))
        state = opt.init(params)
        params, state = opt.apply(params, grads, state)
    """

    def __init__(self, fluid_optimizer):
        self._rule = fluid_optimizer
        if fluid_optimizer.op_type is None:
            raise ValueError("optimizer declares no update op")
        self._kernel = get_op_info(fluid_optimizer.op_type).kernel
        lr = fluid_optimizer._learning_rate
        if not isinstance(lr, float):
            raise ValueError(
                "PytreeOptimizer needs a float learning rate (schedule "
                "variables live in programs)")
        self._lr = lr

    @property
    def slot_names(self):
        """Names of the per-parameter accumulator slots this rule
        carries (velocity/moment/...), for spec introspection."""
        return [spec.name for spec in self._rule.state_slots]

    def state_specs(self, param_specs):
        """Specs for the state `init` builds: each accumulator slot lays
        out exactly like the parameter it tracks, shared scalars
        replicate (None).  `param_specs` is the params dict of specs."""
        return {
            "slots": {name: pytree.tree_map(lambda s: s, param_specs)
                      for name in self.slot_names},
            "shared": {spec.name: None
                       for spec in self._rule.shared_scalars},
        }

    def init(self, params):
        """State dict: one tensor like each param per state slot, at the
        slot's fill, plus the shared scalars at their initial values."""
        slots = {
            spec.name: pytree.tree_map(
                lambda p: torch.full_like(p, spec.fill), params)
            for spec in self._rule.state_slots
        }
        device = pytree.tree_leaves(params)[0].device
        shared = {spec.name: torch.tensor(spec.init, dtype=torch.float32,
                                          device=device)
                  for spec in self._rule.shared_scalars}
        return {"slots": slots, "shared": shared}

    def apply(self, params, grads, state):
        """Returns (new_params, new_state); computes no gradient."""
        rule = self._rule
        attrs = rule._hyper_attrs()
        leaves_p, treedef = pytree.tree_flatten(params)
        lr = torch.tensor(self._lr, dtype=torch.float32,
                          device=leaves_p[0].device)
        leaves_g = _flatten_like(grads, treedef)
        slot_leaves = {spec.name: _flatten_like(state["slots"][spec.name],
                                                treedef)
                       for spec in rule.state_slots}

        new_p, new_slots = [], {spec.name: [] for spec in rule.state_slots}
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(leaves_p, leaves_g)):
                ins = {"Param": [p], "Grad": [g]}
                if rule.uses_lr:
                    ins["LearningRate"] = [lr]
                for spec in rule.state_slots:
                    ins[spec.in_key] = [slot_leaves[spec.name][i]]
                for spec in rule.shared_scalars:
                    ins[spec.in_key] = [state["shared"][spec.name]]
                outs = self._kernel(None, ins, attrs)
                new_p.append(outs["ParamOut"][0])
                for spec in rule.state_slots:
                    new_slots[spec.name].append(outs[spec.out_key][0])

        new_state = {
            "slots": {name: pytree.tree_unflatten(leaves, treedef)
                      for name, leaves in new_slots.items()},
            "shared": {spec.name:
                       state["shared"][spec.name] * spec.step_factor
                       if spec.step_factor is not None
                       else state["shared"][spec.name]
                       for spec in rule.shared_scalars},
        }
        return pytree.tree_unflatten(new_p, treedef), new_state
