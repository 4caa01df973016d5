"""The frozen work counts against values counted by hand at small shapes."""

import pytest
import torch

import bench_support  # noqa: F401 (puts benchmark/ on the path)
from roofline import counts as c

F = 33.5e12  # FP32 instructions a second (67 TFLOP/s, an FMA two)


def test_least_ops_and_pieces():
    assert c.least_ops(11, div=1) == (14, 1)
    assert c.COST_PIECES["flow_px"] == (37, 10)
    assert c.COST_PIECES["flow"] == (55, 13)
    assert c.COST_PIECES["prior"] == (36, 11)
    assert c.P4P_PIECE == (4144, 148)
    assert c.ms_piece(6) == (30, 2)


def test_cost_counts_and_bound_by_hand():
    cands = torch.tensor([[[1.0, 2.0]]])  # K = 1, h = 1, w = 2
    tinb = torch.ones((1, 1, 2), dtype=torch.bool)
    Rs, ts = torch.eye(3)[None], torch.tensor([[0.0, 0.0, -1.5]])  # the first point behind
    prior = (torch.tensor([[[1.0, 0.0]]]), torch.ones((1, 1, 2)), torch.eye(3)[None], torch.zeros((1, 3)))
    n = c.cost_counts(torch, cands, tinb, Rs, ts, 1, 1.0, 1.0, 0.0, 0.0, prior)
    assert n == dict(cands=2, chain=2, flow_px=2, flow=1, prior_px=1, prior_cands=1, prior=1)
    # operations 275 FP32 and 56 special-function; bytes 2 x (4 + 21 + 8) in, 32 out: bytes bind
    assert c.cost_bound_s(n, 1, 1, 2, 1, 1, accept=True) == pytest.approx(98 / 3.35e12)
    assert c.bound_s(0, n, c.COST_PIECES) == pytest.approx(56 * 8 / F)


def test_pose_bound_by_hand():
    # P4P: 2 hypotheses x 4144 FP32 bind (bytes 290); meanshift: 4 weightings,
    # bytes 125 bind (operations 120 FP32)
    got = c.pose_bound_s(B=1, M=10, S=2, T=1, ms_iters=[1], rg_iters=None, rg_max_iters=50)
    assert got == pytest.approx(8288 / F + 125 / 3.35e12)
    # the refit adds 2 E-steps and 1 committed M-step a row: 2 x (116 + 48) FP32 vs 125 + 336 bytes
    got_rg = c.pose_bound_s(B=1, M=10, S=2, T=1, ms_iters=[1], rg_iters=[2], rg_max_iters=50)
    assert got_rg - got == pytest.approx(max(2 * (2 * 58 + 48) / F, (56 + 336 + 13) / 3.35e12))

