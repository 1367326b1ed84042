"""v2 sequence pooling types (reference: python/paddle/v2/pooling.py).  A copy of
paddle_tpu/v2/pooling.py."""

__all__ = ["Max", "Avg", "Sum", "SquareRootN"]


class BasePoolingType:
    name = None


class Max(BasePoolingType):
    name = "max"


class Avg(BasePoolingType):
    name = "average"


class Sum(BasePoolingType):
    name = "sum"


class SquareRootN(BasePoolingType):
    name = "sqrt"
