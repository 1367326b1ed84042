"""TensorArray: a fixed-capacity dense array of tensors (LoDTensorArray).

Counterpart of paddle_tpu/core/tensor_array.py (reference:
paddle/framework/lod_tensor_array.h, tensor_array_read_write_op.cc).
The reference grows a std::vector<LoDTensor>; the JAX side keeps a dense
[capacity, ...] buffer and a scalar length so that an array can be a
loop carry of static shape, and the port keeps the same semantics: the
length is the largest index written plus one, an index outside
[0, capacity) is clamped into it (as `dynamic_update_slice` and
`dynamic_slice` clamp), and `stack` gives zeros past the length.  The
index and the length are tensors on the buffer's device, so a write or
a read never waits on the device.

`TensorArray` is a torch pytree node (the buffer and the length its
leaves), as `RaggedTensor` is: a masked loop selects it leaf by leaf,
and the generic grad differentiates its buffer (`values`).
"""

import torch
import torch.utils._pytree as pytree

__all__ = ["TensorArray", "EmptyTensorArray", "DEFAULT_CAPACITY"]

DEFAULT_CAPACITY = 256


def _index(i, capacity):
    """(the int64 index into the buffer, the index itself): a negative
    index counts from the end, and the result is clamped into
    [0, capacity), as `lax.dynamic_slice` and `dynamic_update_slice`
    take a start index."""
    i = torch.as_tensor(i).reshape(()).to(torch.int64)
    return torch.where(i < 0, i + capacity, i).clamp(0, capacity - 1), i


class TensorArray:
    """buffer: [capacity, ...elem_shape]; length: int32 scalar tensor
    (the number of valid entries, the largest written index + 1)."""

    def __init__(self, buffer, length):
        self.buffer = buffer
        self.length = torch.as_tensor(length, dtype=torch.int32,
                                      device=buffer.device)

    @property
    def capacity(self):
        return self.buffer.shape[0]

    @property
    def values(self):
        """The buffer: what the generic grad differentiates."""
        return self.buffer

    def with_values(self, buffer):
        """The same length over a new buffer."""
        return TensorArray(buffer, self.length)

    def write(self, i, value):
        idx, i = _index(i, self.capacity)
        buf = torch.index_copy(self.buffer, 0, idx.reshape(1),
                               value.unsqueeze(0))
        return TensorArray(buf, torch.maximum(
            self.length, (i + 1).to(torch.int32)))

    def read(self, i):
        idx, _ = _index(i, self.capacity)
        return torch.index_select(self.buffer, 0, idx.reshape(1))[0]

    def stack(self):
        """The dense [capacity, ...] buffer, zeros past the length."""
        keep = torch.arange(self.capacity, device=self.buffer.device) \
            < self.length
        return torch.where(
            keep.reshape((-1,) + (1,) * (self.buffer.dim() - 1)),
            self.buffer, torch.zeros((), dtype=self.buffer.dtype,
                                     device=self.buffer.device))

    @staticmethod
    def from_elem(elem, capacity=DEFAULT_CAPACITY):
        buf = torch.zeros((capacity,) + tuple(elem.shape), dtype=elem.dtype,
                          device=elem.device)
        # made on the device: a host 0 would be a copy that waits
        return TensorArray(buf, torch.zeros((), dtype=torch.int32,
                                            device=elem.device))

    def to(self, device):
        return pytree.tree_map(lambda t: t.to(device), self)

    def __repr__(self):
        return "TensorArray(capacity=%d, elem=%s %s)" % (
            self.capacity, tuple(self.buffer.shape[1:]), self.buffer.dtype)


class EmptyTensorArray:
    """An array made but never written: it has no element shape yet, so
    it cannot be a loop carry (the first write comes before the loop)."""

    def __init__(self, capacity=DEFAULT_CAPACITY):
        self.capacity = capacity

    def write(self, i, value):
        return TensorArray.from_elem(value, self.capacity).write(i, value)

    def __repr__(self):
        return "EmptyTensorArray(capacity=%d)" % self.capacity


def _unflatten(children, _):
    ta = object.__new__(TensorArray)
    ta.buffer, ta.length = children
    return ta


pytree.register_pytree_node(
    TensorArray, lambda ta: ([ta.buffer, ta.length], None), _unflatten,
    serialized_type_name="paddle_tpu_torch.core.tensor_array.TensorArray")
