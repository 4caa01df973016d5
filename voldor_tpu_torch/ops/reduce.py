"""The pose kernels' fixed-order pool sum, in plain torch.

The meanshift and robust-Gaussian kernels (``csrc/meanshift_kernel.cu``,
``csrc/robust_gaussian_kernel.cu``) run one block of ``THREADS`` threads
per search. Every sum over the pool's P rows is taken in one fixed order:
thread t adds rows t, t + THREADS, t + 2 THREADS, ... in turn, then a
halving tree over the threads adds partial t + h into partial t for
h = THREADS / 2, ..., 1 (``csrc/pose_reduce.cuh``). ``block_sum`` is that
order written as elementwise torch operations, so the plain versions round
every sum as the kernels do, on every device, and two runs give the same
bits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

THREADS = 512  # a block of the pose kernels; csrc/pose_reduce.cuh's kThreads


def block_sum(x: torch.Tensor, threads: int = THREADS) -> torch.Tensor:
    """Sum over the last axis of ``x`` in the kernels' order (rows strided
    over ``threads`` lanes, then a halving tree). ``threads`` is a power of
    two."""
    n = x.shape[-1]
    rows = max(-(-n // threads), 1)
    x = F.pad(x, (0, rows * threads - n)).unflatten(-1, (rows, threads))
    acc = x[..., 0, :]
    for r in range(1, rows):
        acc = acc + x[..., r, :]
    width = threads
    while width > 1:
        width //= 2
        acc = acc[..., :width] + acc[..., width:]
    return acc[..., 0]
