"""LoDRankTable: sequences sorted by length, descending.

Counterpart of paddle_tpu/core/rank_table.py (reference:
paddle/framework/lod_rank_table.h).  The DynamicRNN machinery sorts
sequences longest first, so that each step's active batch is a prefix.
A table is host metadata, as in the reference and on the JAX side: the
rank-table ops read a ragged input's splits to the host once to build
one.
"""

__all__ = ["LoDRankTable"]


class LoDRankTable:
    """items: [(original sequence index, length)], by length descending,
    ties in index order."""

    def __init__(self, items):
        self.items = list(items)

    @staticmethod
    def from_lengths(lengths):
        lengths = [int(n) for n in lengths]
        order = sorted(range(len(lengths)), key=lambda i: (-lengths[i], i))
        return LoDRankTable([(i, lengths[i]) for i in order])

    def indices(self):
        return [i for i, _ in self.items]

    def lengths(self):
        return [n for _, n in self.items]

    def max_len(self):
        return self.items[0][1] if self.items else 0

    def active_at(self, step):
        """The sequences still running at `step` (the prefix size)."""
        return sum(1 for _, n in self.items if n > step)

    def __len__(self):
        return len(self.items)

    def __repr__(self):
        return "LoDRankTable(%r)" % (self.items,)
