"""Reader creators (reference: python/paddle/v2/reader/creator.py).

Counterpart of paddle_tpu/reader/creator.py `np_array` and `text_file`.
Its `recordio` and `cloud_reader` read through the JAX package's native
runtime (RecordIO chunks, the task master), which the port does not
have yet.
"""

__all__ = ["np_array", "text_file"]


def np_array(x):
    """Yield the rows of an ndarray."""

    def reader():
        for row in x:
            yield row

    return reader


def text_file(path):
    """Yield the lines of a text file, without their newline."""

    def reader():
        with open(path) as f:
            for line in f:
                yield line.rstrip("\n")

    return reader
