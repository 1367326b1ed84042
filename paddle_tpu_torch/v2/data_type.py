"""v2 input type declarations (reference: python/paddle/v2/data_type.py
over paddle/trainer/PyDataProviderWrapper InputType).  A copy of
paddle_tpu/v2/data_type.py."""

__all__ = [
    "dense_vector", "dense_array", "dense_vector_sequence",
    "dense_vector_sub_sequence", "integer_value",
    "integer_value_sequence", "integer_value_sub_sequence",
    "sparse_binary_vector", "sparse_float_vector", "InputType",
]


class InputType:
    def __init__(self, dim, seq_level, dtype, shape=None):
        self.dim = dim
        self.seq_level = seq_level
        self.dtype = dtype
        self.shape = shape if shape is not None else [dim]


def dense_vector(dim, seq_type=0):
    return InputType(dim, seq_type, "float32")


def dense_array(dim, shape, seq_type=0):
    return InputType(dim, seq_type, "float32", shape=list(shape))


def dense_vector_sequence(dim):
    return InputType(dim, 1, "float32")


def dense_vector_sub_sequence(dim):
    """Nested sequence of dense vectors (reference: data_type.py
    seq_type=2 — sequence of subsequences)."""
    return InputType(dim, 2, "float32")


def integer_value(value_range, seq_type=0):
    return InputType(value_range, seq_type, "int64", shape=[1])


def integer_value_sequence(value_range):
    return InputType(value_range, 1, "int64", shape=[1])


def integer_value_sub_sequence(value_range):
    return InputType(value_range, 2, "int64", shape=[1])


def sparse_binary_vector(dim, seq_type=0):
    # sparse inputs feed as integer id lists (lookup-table style)
    return InputType(dim, max(seq_type, 1), "int64", shape=[1])


def sparse_float_vector(dim, seq_type=0):
    return InputType(dim, max(seq_type, 1), "float32")
