"""The least work of the frame-alignment kernels' calls, frozen.

Copies of the repository's falign work counts (the linearisation's work a
pixel counted from its plain formula, ``falign/residual.py``), so that a
later change to the program cannot move them, at the peaks of
``counts.py``. One ``falign_pairs`` call of P photometric pairs (2 P pair
evaluations) runs, in each phase (the coarse grid first where it runs),
one linearisation at the phase's start and, per lane, as many LM
iterations as the lane ran, each a linearisation of the lane's two pair
evaluations and the damped solve of its 18 x 18 system; then one
linearisation for the covariances and one scores pass, at the fine stride.
"""

from __future__ import annotations

from roofline.counts import bound_s, least_ops

# a pixel of a pair evaluation: the grid coordinates (2 sub, 2 div), the
# points in the ref and tar cameras (34), the projection and its tests (17,
# div), the sampled taps with their derivatives (16 + 5 x 21), the
# geometric term and its tests (38, 2 div), the weights and the photometric
# term (14, div), the robustifier (5, log, sqrt), the reverse pass (30 + 3
# x 41, 3 div), the pose, scale and colour columns (95) and the masks (18)
FALIGN_PX = least_ops(495, div=9, sqrt=1, log=1)
# the 190 products of a pixel's Gram matrix, one FMA each
FALIGN_GRAM = least_ops(190)
# scores mode a pixel: the back-projection (2 sub, 2 div, 3), two rotations
# (2 x 24) and their offsets (6), the projection and its tests (17, 2 div),
# the taps (16 + 5 x 7), the geometric term (30, 2 div), the photometric
# term (7), the robustifier (5, log, sqrt) and the score (5, div)
FALIGN_SCORE_PX = least_ops(170, div=7, sqrt=1, log=1)
# bytes a pixel of a pair evaluation reads at the least: the ref frame's
# depth, weight and image at the strided grid
PX_BYTES = 12
D = 18  # a two-frame lane's parameters


def grid_px(h: int, w: int, stride: int) -> int:
    """Pixels of the strided grid (``arange(0, h, stride)`` x ``arange(0, w, stride)``)."""
    return -(-h // stride) * -(-w // stride)


def lm_solve_piece(pairs: int):
    """A lane's damped solve and its system's assembly: the factor (D^3 / 6
    FMAs, D square roots, D^2 / 2 divisions), the two solves (D^2) and the
    adds of its pairs' Gram blocks."""
    return least_ops(D ** 3 // 6 + D * D + pairs * 190, div=D * D // 2 + 2 * D, sqrt=D)


def call_bound_s(P: int, h: int, w: int, stride: int, coarse_stride: int, iters, iters_coarse) -> float:
    """Least seconds of one photometric ``falign_pairs`` call's kernels:
    ``iters`` and ``iters_coarse`` are the lanes' LM iterations on the
    fine and the coarse grid (the coarse grid runs where coarse_stride >
    stride)."""
    B = 2 * P
    phases = [(stride, sum(iters))]
    if coarse_stride > stride:
        phases.insert(0, (coarse_stride, sum(iters_coarse)))
    t = 0.0
    for s, lane_iters in phases:
        px = grid_px(h, w, s)
        t += bound_s(B * px * PX_BYTES, {"px": B * px, "gram": B * px},
                     {"px": FALIGN_PX, "gram": FALIGN_GRAM})
        t += bound_s(0, {"px": lane_iters * 2 * px, "gram": lane_iters * 2 * px, "lm": lane_iters},
                     {"px": FALIGN_PX, "gram": FALIGN_GRAM, "lm": lm_solve_piece(2)})
    px = grid_px(h, w, stride)
    t += bound_s(B * px * PX_BYTES, {"px": B * px, "gram": B * px}, {"px": FALIGN_PX, "gram": FALIGN_GRAM})
    t += bound_s(B * px * PX_BYTES, {"px": B * px}, {"px": FALIGN_SCORE_PX})
    return t

