"""The comparison that decides ``correct`` fails where it should: the
control (stale answers: each published motion and keyframe map
replaced by the one published before it) and faults planted under the
timed path, each through a whole dry run on the CPU with the harness's
look for a card skipped."""

import numpy as np
import pytest
import torch

from bench_support import BENCH, one_thread, tiny  # noqa: F401 (fixtures)
import run

SEED = 3_000_000_019


@pytest.fixture
def plant(monkeypatch):
    """Plants ``fault(vo_ret)`` where the window's answers are produced."""
    from voldor_tpu_torch.vo import api

    def install(fault):
        collect = api.VoWindow.collect

        def broken(self):
            out = collect(self)
            fault(self, out)
            return out

        monkeypatch.setattr(api.VoWindow, "collect", broken)
    return install


def _verdict(root, workload, seconds=3.0):
    cell = run.Cell(root, workload, bench=BENCH)
    return run.run(cell, SEED, seconds, False, device="cpu")


def _state_unchanged(win, out):
    out["poses"][:] = 0.0  # the step returns the camera where it was


def _pose_altered(win, out):
    out["poses"][0, 3:6] *= -1.0  # the first published motion's translation reversed


def _depth_altered(win, out):
    # the depth map the window publishes, bent: 0.6x at its left edge, 1.4x at its right
    d = win.depth_dev
    d.mul_(torch.linspace(0.6, 1.4, d.shape[-1], dtype=d.dtype, device=d.device))


@pytest.mark.parametrize("fault", [_state_unchanged, _pose_altered, _depth_altered])
def test_a_planted_fault_is_not_correct(tiny, one_thread, plant, fault):
    plant(fault)
    out = _verdict(tiny, "kitti-stereo.stream")
    assert out["correct"] is False, out["checks"]


def test_the_control_is_not_correct_where_the_program_is(tiny, one_thread):
    import reference

    cell = run.Cell(tiny, "kitti-stereo.stream", bench=BENCH)
    ctx = run.Context(cell, SEED, "cpu", False, torch)
    drv = cell.driver(ctx)
    drv.setup()
    drv.window(3.0)
    program, control = drv.judge(), drv.judge(control=True)
    drv.close()
    bad, rows = reference.verdict(control, cell.limits["numbers"])
    assert not bad, rows
    # at this size the limits set at the cell's size need not hold for the
    # program; the control still reads far worse on the translation
    assert np.isfinite(program["t_err"]) and control["t_err"] > 10 * program["t_err"]
