"""The least-time arithmetic on shapes counted by hand."""

import torch

from benchmark import roofline


def _table():
    # one tree of three leaves over six rows: leaf 0 = {0, 1}, leaf 1 =
    # {2, 3, 4}, leaf 2 = {5}
    lens = torch.tensor([2, 3, 1])
    table = torch.tensor([[[0, 1, -1], [2, 3, 4], [5, -1, -1]]])
    return lens, table


def test_blocked_chunk_work():
    lens, table = _table()
    tree = torch.zeros((2, 2), dtype=torch.int64)
    leaf = torch.tensor([[0, 1], [1, -1]])
    nbytes, ops = roofline.chunk_work(tree, leaf, lens, table, 6, 4, 10, 4,
                                      shared=False)
    # pairs' filled rows 2 + 3 + 3 = 8, 2 * D = 8 operations each
    assert ops == 8 * 8
    # distinct leaves 0, 1: 5 filled rows of 4 * 4 bytes + a 4-byte norm;
    # 2 query rows of 16 bytes; 2 * 10 results of 8 bytes
    assert nbytes == 5 * 20 + 2 * 16 + 2 * 10 * 8


def test_shared_chunk_work():
    lens, table = _table()
    tree = torch.zeros((2, 2), dtype=torch.int64)
    leaf = torch.tensor([[1, 2], [2, -1]])
    nbytes, ops = roofline.chunk_work(tree, leaf, lens, table, 6, 4, 10, 4,
                                      shared=True)
    assert ops == (3 + 1 + 1) * 8
    # distinct rows 2, 3, 4, 5 of 16 bytes; 4 filled slots of id + norm
    assert nbytes == 4 * 16 + 4 * 8 + 2 * 16 + 2 * 10 * 8


def test_least_seconds_takes_the_larger_bound():
    assert roofline.least_seconds(3.35e12, 0) == 1.0
    assert roofline.least_seconds(0, 67e12) == 1.0
    assert roofline.least_seconds(3.35e9, 67e12) == 1.0


def test_card_without_nvidia_smi(monkeypatch):
    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")
    monkeypatch.setattr(roofline.subprocess, "run", missing)
    assert roofline.card() == {}
