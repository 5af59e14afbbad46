"""``core.LoDTensor`` and ``core.SelectedRows`` (host-side numpy, as in the
JAX package), the port against the JAX package: the offset LoD and its
checks, recursive lengths, the padded bridge both ways, and the sparse
rows' merge, densification and construction.  Values equal."""
import numpy as np
import pytest

import paddle_tpu.core as JC
import paddle_tpu_torch.core as TC


def test_exported_as_in_the_jax_package():
    assert TC.LoDTensor is TC.lod.LoDTensor
    assert TC.SelectedRows is TC.lod.SelectedRows
    assert set(TC.lod.__all__) == set(JC.lod.__all__)


@pytest.mark.parametrize("lod", [[[0, 2, 5]], [[0, 1, 3], [0, 2, 3, 6]]])
def test_lod_levels_and_lengths(lod):
    data = np.arange(12, dtype=np.float32).reshape(-1, 2)
    j, t = JC.LoDTensor(data, lod), TC.LoDTensor(data, lod)
    assert t.lod() == j.lod() == lod
    assert t.recursive_sequence_lengths() == j.recursive_sequence_lengths()
    assert t.has_valid_recursive_sequence_lengths() \
        == j.has_valid_recursive_sequence_lengths()
    assert t.shape == j.shape and len(t) == len(j)
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    t2 = TC.LoDTensor(data)
    t2.set_recursive_sequence_lengths(t.recursive_sequence_lengths())
    assert t2.lod() == lod


@pytest.mark.parametrize("bad", [[[1, 2]], [[0, 3, 2]], [[0, 1, 2],
                                                         [0, 1]]])
def test_invalid_lod_raises_in_both(bad):
    for mod in (JC, TC):
        with pytest.raises(ValueError):
            mod.LoDTensor(np.zeros((3, 1)), bad)


@pytest.mark.parametrize("maxlen", [None, 2, 6])
def test_padded_bridge(maxlen):
    data = np.random.default_rng(0).normal(size=(9, 3)).astype(np.float32)
    lod = [[0, 4, 4, 9]]
    jp, jl = JC.LoDTensor(data, lod).to_padded(maxlen, -1.0)
    tp, tl = TC.LoDTensor(data, lod).to_padded(maxlen, -1.0)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tl, jl)
    back = TC.LoDTensor.from_padded(*TC.LoDTensor(data, lod).to_padded())
    assert back.lod() == lod
    np.testing.assert_array_equal(np.asarray(back), data)
    with pytest.raises(ValueError):
        TC.LoDTensor(data).to_padded()


def test_selected_rows():
    rows = [3, 1, 3, 0, 1]
    value = np.arange(15, dtype=np.float32).reshape(5, 3)
    j, t = JC.SelectedRows(rows, 5, value), TC.SelectedRows(rows, 5, value)
    jm, tm = j.merge_add(), t.merge_add()
    assert tm.rows() == jm.rows() == [0, 1, 3]
    np.testing.assert_array_equal(tm.get_tensor(), jm.get_tensor())
    np.testing.assert_array_equal(t.to_dense(), j.to_dense())
    np.testing.assert_array_equal(tm.to_dense(), t.to_dense())
    dense = np.random.default_rng(1).normal(size=(6, 2))
    jf = JC.SelectedRows.from_dense_rows(dense, [4, 0])
    tf_ = TC.SelectedRows.from_dense_rows(dense, [4, 0])
    assert tf_.height() == jf.height() == 6
    np.testing.assert_array_equal(tf_.get_tensor(), jf.get_tensor())
    with pytest.raises(ValueError):
        TC.SelectedRows([1, 2], 3, np.zeros((3, 2)))
    empty = TC.SelectedRows([0], 0, np.zeros((1, 2)))
    with pytest.raises(ValueError, match="height"):
        empty.to_dense()
    empty.set_height(2)
    assert empty.to_dense().shape == (2, 2)
