"""The five datasets that had no port file — flowers, mq2007 (pairwise
and listwise), sentiment, voc2012 and wmt16: each reader of the port
yields, item by item, what the JAX package's reader yields (the same
synthetic stand-ins from the same seeds), and the module surfaces
match."""

import numpy as np
import pytest

import paddle_tpu.dataset as jdata
import paddle_tpu_torch.dataset as tdata

READERS = [
    ("flowers", "train", {}), ("flowers", "test", {}),
    ("flowers", "valid", {}),
    ("mq2007", "train", {"format": "pairwise"}),
    ("mq2007", "train", {"format": "listwise"}),
    ("mq2007", "test", {"format": "listwise"}),
    ("sentiment", "train", {}), ("sentiment", "test", {}),
    ("voc2012", "train", {}), ("voc2012", "test", {}),
    ("voc2012", "val", {}),
    ("wmt16", "train", {"src_dict_size": 300, "trg_dict_size": 500}),
    ("wmt16", "test", {}),
]


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("module,split,kw", READERS,
                         ids=["%s_%s_%s" % (m, s, "_".join(
                             str(v) for v in kw.values()))
                              for m, s, kw in READERS])
def test_reader_yields_the_jax_items(module, split, kw):
    """One pass of each reader (a reader's generator advances between
    passes, on both sides)."""
    jitems = list(getattr(getattr(jdata, module), split)(**kw)())
    titems = list(getattr(getattr(tdata, module), split)(**kw)())
    assert len(titems) == len(jitems) > 0
    for a, b in zip(jitems, titems):
        _equal(a, b)


@pytest.mark.parametrize("module", ["flowers", "mq2007", "sentiment",
                                    "voc2012", "wmt16"])
def test_module_surface(module):
    j, t = getattr(jdata, module), getattr(tdata, module)
    assert t.__all__ == j.__all__
    assert module in tdata.__all__
    for name in ("FEATURE_DIM", "CLASS_NUM", "NUM_TRAINING_INSTANCES",
                 "NUM_TOTAL_INSTANCES"):
        assert getattr(t, name, None) == getattr(j, name, None)
    if module == "sentiment":
        assert t.get_word_dict() == j.get_word_dict()
    if module == "wmt16":
        assert t.get_dict("de", 40) == j.get_dict("de", 40)
