"""The port's text datasets (``paddle_tpu_torch.text.datasets``) against the
JAX package's, on the CPU: every dataset in each mode, built from the same
synthetic corpus (no data file), has the same length and the same items bit
for bit (values and numpy dtypes) at sampled indices; and
``paddle_tpu_torch.text`` exports the eight datasets beside ERNIE's names.
"""
import numpy as np
import pytest

import paddle_tpu.text as jtext
import paddle_tpu_torch.text as ttext

# (dataset, keyword arguments): small synthetic sizes keep the builds fast
CASES = [
    ("Imdb", dict(synthetic_size=96)),
    ("Imdb", dict(synthetic_size=64, maxlen=48, cutoff=10)),
    ("Imikolov", dict(synthetic_size=300, window_size=5)),
    ("UCIHousing", dict()),
    ("Conll05st", dict(synthetic_size=40, maxlen=24)),
    ("Movielens", dict(synthetic_size=200, title_len=6)),
    ("WMT14", dict(synthetic_size=50, maxlen=16)),
    ("WMT16", dict(synthetic_size=50, maxlen=16)),
    ("MovieReviews", dict(synthetic_size=60, maxlen=40)),
]


def _items_equal(a, b, where):
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _items_equal(x, y, f"{where}[{i}]")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype)
    assert np.array_equal(a, b), where


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("name,kwargs", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_dataset_items_are_the_reference_items(name, kwargs, mode):
    jd = getattr(jtext, name)(mode=mode, **kwargs)
    td = getattr(ttext, name)(mode=mode, **kwargs)
    assert len(td) == len(jd) > 0
    rng = np.random.default_rng(len(jd))
    for i in sorted({0, len(jd) - 1, *rng.integers(0, len(jd), 6).tolist()}):
        _items_equal(td[i], jd[i], f"{name}[{i}]")


def test_dataset_dictionaries_are_the_reference_dictionaries():
    assert ttext.Imdb(synthetic_size=8).word_idx == \
        jtext.Imdb(synthetic_size=8).word_idx
    jc, tc = jtext.Conll05st(synthetic_size=4), ttext.Conll05st(
        synthetic_size=4)
    assert (tc.word_dict, tc.predicate_dict, tc.label_dict, tc.n_labels) == \
        (jc.word_dict, jc.predicate_dict, jc.label_dict, jc.n_labels)


def test_text_exports_the_datasets_beside_ernie():
    from paddle_tpu_torch.text import datasets as tds

    names = set(jtext.datasets.__all__)
    assert names == set(tds.__all__)
    for n in names:
        assert getattr(ttext, n) is getattr(tds, n)
    assert {"ErnieModel", "ErnieForSequenceClassification"} <= set(dir(ttext))
