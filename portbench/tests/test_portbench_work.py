"""The work counts of ``portbench/work`` on small cases worked by hand."""

import pytest

from portbench.work import b1, b2, b5, peaks


def test_b1_level_by_hand():
    # 4 rows, 1 tree at 1 node, 1 split of 2 branches, 2 classes: each
    # input a byte a row (node id, branch, class, count) and 4 counts of
    # 4 bytes; a row is in a 4-draw bootstrap with probability
    # 1 - (3/4)^4, so 4 * 0.68359375 weighted (row, split) adds
    got = b1.level(4, 1, 1, 1, 2, 2, 255, 100.0)
    assert got["bytes"] == 4 * 4 + 4 * 4
    assert got["ops"] == pytest.approx(4 * (1 - 0.75 ** 4))
    assert got["bound_by"] == "bytes"
    assert got["seconds"] == pytest.approx(32 / peaks.HBM_BYTES_PER_S)


def test_b1_build_sums_its_levels():
    # levels of 1, 2 and 4 nodes: the counts grow with the nodes
    got = b1.build(4, 1, 1, 2, 2, 3, 255, 100.0)
    assert got["bytes"] == 3 * 16 + (1 + 2 + 4) * 2 * 2 * 4


def test_b1_wide_node_ids_take_two_bytes():
    assert b1.level(1, 1, 256, 1, 2, 2, 255, 100.0)["bytes"] == \
        1 * (2 + 1 + 1 + 1) + 256 * 4 * 4


def test_b2_call_by_hand():
    # 10 rows of 5 feature bytes, 3 trees of 4 paths over 4 features (two
    # float32 bounds a feature and a class byte a path), one byte out a
    # row; 10 rows x 3 trees x 2 levels of compares
    got = b2.call(10, 3, 4, 2, 5, 4)
    assert got["bytes"] == 50 + 3 * 4 * 33 + 10
    assert got["ops"] == 60


def test_b5_batch_by_hand():
    # 2 test and 3 train rows of 4 float32 features, 2 (distance, index)
    # pairs of 8 bytes a test row; 8 operations a pair
    got = b5.batch(2, 3, 4, 0, 2)
    assert got["bytes"] == 5 * 16 + 2 * 2 * 8
    assert got["ops"] == 6 * 8
    # 40 one-hot bytes are 2 words: an AND and a popcount each
    assert b5.batch(1, 1, 0, 40, 1)["ops"] == 4 + 2 * 2


def test_b5_at_the_cell_is_bound_by_operations():
    got = b5.batch(20000, 200000, 4, 0, 7)
    assert got["bound_by"] == "operations"
    assert got["seconds"] == pytest.approx(20000 * 200000 * 8 / 33.5e12)


def test_width_bytes():
    assert [peaks.width_bytes(v) for v in (2, 256, 257, 65536, 65537)] == \
        [1, 1, 2, 2, 4]
