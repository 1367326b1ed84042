"""v2 training events (reference: python/paddle/v2/event.py).  A copy of
paddle_tpu/v2/event.py."""

__all__ = ["BeginPass", "EndPass", "BeginIteration", "EndIteration",
           "EndForwardBackward", "TestResult"]


class WithMetric:
    def __init__(self, evaluator=None):
        self.evaluator = evaluator


class TestResult(WithMetric):
    def __init__(self, evaluator=None, cost=None):
        WithMetric.__init__(self, evaluator)
        self.cost = cost


class BeginPass:
    def __init__(self, pass_id):
        self.pass_id = pass_id


class EndPass(WithMetric):
    def __init__(self, pass_id, evaluator=None, gm=None):
        WithMetric.__init__(self, evaluator)
        self.pass_id = pass_id
        self.gm = gm


class BeginIteration:
    def __init__(self, pass_id, batch_id):
        self.pass_id = pass_id
        self.batch_id = batch_id


class EndForwardBackward:
    def __init__(self, pass_id, batch_id, gm=None):
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.gm = gm


class EndIteration(WithMetric):
    def __init__(self, pass_id, batch_id, cost, evaluator=None, gm=None):
        WithMetric.__init__(self, evaluator)
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.cost = cost
        self.gm = gm
