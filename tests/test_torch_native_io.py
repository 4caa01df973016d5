"""The port's native flow loader (voldor_tpu_torch/native) against the JAX
package's (voldor_tpu/native/io.py) and the .flo reader, on the same files
written from a seed: arrays equal exactly (both read the same float32
bytes), as tests/test_native_io.py holds the JAX package's loader.
"""

import numpy as np
import pytest

from voldor_tpu_torch.native import io as tio
from voldor_tpu_torch.native.io import NativeFlowDir
from voldor_tpu_torch.utils.flow_io import load_flow, save_flow


@pytest.fixture
def flow_dir(tmp_path, rng):
    flows = rng.normal(0, 4, (12, 24, 32, 2)).astype(np.float32)
    d = tmp_path / "flows"
    d.mkdir()
    for i in range(12):
        save_flow(str(d / f"{i:06d}.flo"), flows[i])
    return d, flows


def test_native_loader_matches_jax_and_files(flow_dir):
    from voldor_tpu.native.io import NativeFlowDir as JaxNativeFlowDir

    d, flows = flow_dir
    src = NativeFlowDir(str(d), n_prefetch=4, n_threads=2)
    ref = JaxNativeFlowDir(str(d), n_prefetch=4, n_threads=2)
    assert src.native, "the native loader should build where g++ exists"
    assert len(src) == len(ref) == 12
    assert (src.h, src.w) == (ref.h, ref.w) == (24, 32)
    for i in range(12):  # sequential access (the VO pattern)
        got = src.get(i)
        np.testing.assert_array_equal(got, ref.get(i))
        np.testing.assert_array_equal(got, load_flow(str(d / f"{i:06d}.flo")))
        np.testing.assert_array_equal(got, flows[i])
    # lookback after eviction: a synchronous re-read
    np.testing.assert_array_equal(src.get(0), flows[0])
    np.testing.assert_array_equal(src.get(7), flows[7])
    src.close()
    ref.close()


def test_native_loader_close_wakes_idle_workers(tmp_path):
    """Open, read every file, close: 2,000 times. With every file read the
    workers idle on their wait, and close must wake them to join. Setting
    the stop flag outside the mutex let a worker that had just found its
    wait predicate false miss the wake-up, and close then waited forever
    (within 800 cycles in each of 10 runs of this loop on a CPU; 2,000
    cycles take under a second with the flag set under the mutex)."""
    import threading

    d = tmp_path / "flows"
    d.mkdir()
    for i in range(8):
        save_flow(str(d / f"{i:06d}.flo"), np.zeros((4, 4, 2), np.float32))
    done = []

    def cycles():
        for _ in range(2000):
            src = NativeFlowDir(str(d), n_threads=2)
            for i in range(8):
                src.get(i)
            src.close()
            done.append(src.native)

    t = threading.Thread(target=cycles, daemon=True)
    t.start()
    t.join(60)
    assert not t.is_alive(), f"close never returned after {len(done)} cycles"
    assert len(done) == 2000 and all(done)


def test_native_loader_range(flow_dir):
    d, flows = flow_dir
    src = NativeFlowDir(str(d), range=(3, 8))
    assert len(src) == 5
    np.testing.assert_array_equal(src.get(0), flows[3])
    np.testing.assert_array_equal(src.get(4), flows[7])
    src.close()


def test_native_loader_out_of_range(flow_dir):
    d, _ = flow_dir
    src = NativeFlowDir(str(d))
    with pytest.raises(IOError):
        src.get(99)
    with pytest.raises(IOError):
        src.get(-1)
    src.close()


def test_python_reader_fallback(flow_dir, monkeypatch, capsys):
    """Where the library cannot be built, the loader says so and reads
    with the Python reader: the same arrays, the same range and errors."""
    d, flows = flow_dir
    monkeypatch.setattr(tio, "_lib", None)
    monkeypatch.setattr(tio, "_build_failed", False)
    monkeypatch.setattr(tio, "BUILD_DIR", d.parent / "nobuild")
    monkeypatch.setenv("CXX", str(d.parent / "no-such-compiler"))
    src = NativeFlowDir(str(d), range=(2, 6))
    assert not src.native and "using Python IO" in capsys.readouterr().out
    assert len(src) == 4 and (src.h, src.w) == (24, 32)
    np.testing.assert_array_equal(src.get(0), flows[2])
    with pytest.raises(IOError):
        src.get(4)


@pytest.mark.parametrize("native", [True, False])
def test_no_flow_files_raises(flow_dir, tmp_path, monkeypatch, native):
    """An empty directory, or a range that takes no file, raises the flow
    loader's RuntimeError on either reader (not an IndexError, nor a loader
    of 0 files that sets N_FRAMES = 1)."""
    from voldor_tpu_torch.slam.system import VOLDOR_SLAM

    d, _ = flow_dir
    if not native:
        monkeypatch.setattr(tio, "_lib", None)
        monkeypatch.setattr(tio, "_build_failed", True)
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "notes.txt").write_text("not a flow")
    for path, rng_ in ((empty, (0, 0)), (d, (20, 30))):
        with pytest.raises(RuntimeError, match="no .flo files"):
            NativeFlowDir(str(path), range=rng_)
        slam = VOLDOR_SLAM(mode="mono", device="cpu")
        with pytest.raises(RuntimeError, match="no .flo files"):
            slam.flow_loader(str(path), range=rng_)
        assert slam.N_FRAMES != 1


def test_library_builds_into_the_ports_build_dir():
    import voldor_tpu_torch
    from pathlib import Path

    so = tio.library_path()
    assert tio._load_lib() is not None and so.exists()
    pkg = Path(voldor_tpu_torch.__file__).resolve().parent
    assert so.parent == pkg / "_build"
    assert "voldor_tpu" not in so.parent.relative_to(pkg.parent).parts


def test_flow_and_disp_loaders_take_the_native_path(flow_dir, capsys):
    """flow_loader prints "(native IO)"; the disparity loader over a .flo
    directory (KITTI stereo: the negated x-flow, voldor_slam.py:302-309)
    reads through the prefetcher and gives exactly -flow[..., 0]."""
    from voldor_tpu_torch.slam.system import VOLDOR_SLAM

    d, flows = flow_dir
    slam = VOLDOR_SLAM(mode="stereo", device="cpu")
    slam.flow_loader(str(d), range=(0, 5))
    assert "5 flows loaded (native IO)" in capsys.readouterr().out
    assert slam.N_FRAMES == 6 and (slam.h, slam.w) == (24, 32)
    for i in range(5):
        np.testing.assert_array_equal(slam.flows[i], flows[i])

    opened = []
    orig = tio.NativeFlowDir.__init__

    def spy(self, *a, **k):
        orig(self, *a, **k)
        opened.append(self.native)

    tio.NativeFlowDir.__init__ = spy
    try:
        slam = VOLDOR_SLAM(mode="stereo", device="cpu")
        slam.h, slam.w = 24, 32
        slam.flow_loader_pt = 1  # the disparity loader waits on the flow loader
        slam.N_FRAMES = 13
        slam.disp_loader(str(d))
    finally:
        tio.NativeFlowDir.__init__ = orig
    assert opened == [True]
    assert len(slam.disps) == 12
    for i in range(12):
        np.testing.assert_array_equal(slam.disps[i], -flows[i][..., 0])
