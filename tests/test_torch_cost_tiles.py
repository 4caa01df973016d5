"""The cost kernel's launch geometry (voldor_tpu_torch/ops/cost.py:geometry)
and the premises of its design, on the CPU.

The kernel (csrc/cost_kernel.cu) runs a block per tile of `tile`
consecutive pixels of the band and all K candidates (thread t: candidate
t // tile at pixel t % tile); the wrapper passes the tile, and the entry
point derives the threads, shared bytes and grid from it as ``geometry``
does (chip_smoke.py phase 6 holds the two to each other on the card). The
tests here hold the geometry's grid to the band: every pixel in one block,
no block empty. The kernel's own index arithmetic and results are held to
its plain version on the card (tests/test_torch_cost.py, marked ``gpu``;
chip_smoke.py phases 4, 5 and 19).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from voldor_tpu_torch.ops import cost as tcost

CSRC = Path(tcost.__file__).resolve().parent.parent / "csrc" / "cost_kernel.cu"

SHAPES = [(185, 613, 0), (7, 1, 0), (1, 1, 0), (13, 37, 0), (46, 613, 139)]


@pytest.mark.parametrize("K", [1, 4, 10, 16])
@pytest.mark.parametrize("h,w,y0", SHAPES)
def test_geometry_covers_each_pixel_once(K, h, w, y0):
    """Ragged shapes (w = 1, h * w not a multiple of the tile, a band whose
    first image row is y0 > 0), N = 1..8, D = 0..4: a block a tile of
    consecutive pixels, K threads a pixel, the last block holding the
    band's last pixel and no block empty, within the launch bounds and the
    default 48 KB of shared memory."""
    hw = h * w
    for N in range(1, 9):
        for D in range(5):
            g = tcost.geometry(K, N, D, h, w)
            assert g.threads == K * g.tile and g.tile % 32 == 0 and g.threads <= tcost.MAX_THREADS
            assert (g.grid - 1) * g.tile < hw <= g.grid * g.tile
            assert g.smem == g.tile * (33 * N + 20 * D + 8 * K) <= tcost.SMEM_LIMIT
            # block b takes pixels [b * tile, (b + 1) * tile) of the band
            pix = np.arange(g.grid)[:, None] * g.tile + np.arange(g.tile)[None]
            assert np.array_equal(pix[pix < hw], np.arange(hw))
            rows = pix[pix < hw] // w + y0
            assert rows.min() == y0 and rows.max() == y0 + h - 1


def test_geometry_shared_memory_and_refusals():
    """Every case up to K = 16, N = 8, D = 4 fits the 48 KB a block gets
    without opting in (so within the card's 227 KB); a launch past the
    kernel's 768 threads or past 48 KB is refused."""
    for K in (1, 4, 10, 16):
        g = tcost.geometry(K, tcost.MAX_N, tcost.MAX_D, 185, 613)
        assert g.smem <= tcost.SMEM_LIMIT <= 232_448
        assert tcost.geometry(K, 5, 2, 185, 613).tile == (128 if K == 1 else 32)
    with pytest.raises(ValueError):  # 25 x 32 threads
        tcost.geometry(25, 5, 2, 185, 613)
    with pytest.raises(ValueError):  # 128 pixels of 9 frames and 4 priors: 49,280 B
        tcost.geometry(1, 9, 4, 185, 613)


def test_params_match_the_kernel_struct():
    """The ctypes mirror of CostParams names the C struct's fields in its
    order and with its types (the tile among them)."""
    src = CSRC.read_text()
    body = re.search(r"struct CostParams \{(.*?)\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if line:
            ctype, names = line.rstrip(";").split(None, 1)
            fields += [(n.strip(), ctype) for n in names.split(",")]
    py = [(name, "float" if t is tcost.ctypes.c_float else "int")
          for name, t in tcost._CostParams._fields_]
    assert py == fields


def test_pow_minus_two_is_reciprocal_square():
    """torch.pow(v, -2.0) is 1 / (v * v) with one IEEE division, bitwise,
    on the CPU (the kernel computes (1 + u^-c)^-2 so; chip_smoke.py phase 6
    checks the same on the card): v = 1 + u^-c over 10^6 draws of u and the
    Fisk shape c, and 10^6 draws of v in [1, 1e6]."""
    rng = np.random.default_rng(13)
    u = torch.as_tensor(np.exp(rng.uniform(-30.0, 30.0, 1_000_000)).astype(np.float32))
    c = torch.as_tensor(rng.uniform(0.78, 0.9956, 1_000_000).astype(np.float32))
    v = torch.cat([1.0 + torch.pow(u, -c),
                   torch.as_tensor(rng.uniform(1.0, 1e6, 1_000_000).astype(np.float32))])
    assert torch.equal(torch.pow(v, -2.0), torch.ones_like(v) / (v * v))
