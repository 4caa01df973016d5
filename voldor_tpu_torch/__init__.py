"""voldor_tpu_torch — the PyTorch + CUDA port of voldor_tpu.

Mirrors ``voldor_tpu``'s module paths and function names; the JAX package
is the reference it is tested against. This package imports torch and
numpy, never jax and nothing from ``voldor_tpu``.

Ported so far: the SLAM layer (``VOLDOR_SLAM(mode="mono" | "stereo" |
"mono-scaled")`` from ``slam/system.py``: ``process_vo`` / ``vo_thread``,
the file loaders, loop closure (``enable_loop_closure``,
``slam/loop_closure.py``) and the mapping half, ``mapping_thread`` with its
frame-alignment links and ``solve_pgo``; map checkpoints and the headless
viewer) and the demo CLI (``python -m voldor_tpu_torch.demo``), over the VO
window entry points (``voldor``, ``voldor_dispatch``), frame alignment
(``falign``, ``falign.api.falign_pairs``) and pose-graph optimisation
(``pgo``). The VO depth rounds run the hand-written CUDA kernels in
``csrc/``. The JAX package's reference-exact VO configuration runs here
too (``--pose_window_sweep seq --pose_collect_mode traced
--depth_cost_mode projected``, with ``--depth_local_prop_mode exact`` and
the AP3P solver, ``--lambdatwist 0``), as do the engine's debug entry
points (``vo/engine.py``: ``solve_stepwise``, ``save_result``, the KITTI
ground estimate) and the SLAM layer's ``debug_dir``.

Without a ``device`` argument the port runs on the CUDA device and raises
when there is none; CPU callers pass ``device="cpu"``.

Pose math needs true float32: TF32 is switched off for matmuls and cuDNN
here (the JAX package sets its matmul precision to "highest" for the same
reason, ``voldor_tpu/__init__.py:43``).
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from voldor_tpu_torch.config import VoldorConfig  # noqa: E402
from voldor_tpu_torch.slam.system import VOLDOR_SLAM  # noqa: E402

__version__ = "0.1.0"

__all__ = ["VoldorConfig", "VOLDOR_SLAM", "voldor", "voldor_dispatch", "falign", "pgo", "__version__"]


def voldor(*args, **kwargs):
    from voldor_tpu_torch.vo.api import voldor as _voldor

    return _voldor(*args, **kwargs)


def voldor_dispatch(*args, **kwargs):
    from voldor_tpu_torch.vo.api import voldor_dispatch as _dispatch

    return _dispatch(*args, **kwargs)


def falign(*args, **kwargs):
    from voldor_tpu_torch.falign.api import falign as _falign

    return _falign(*args, **kwargs)


def pgo(*args, **kwargs):
    from voldor_tpu_torch.pgo.api import pgo as _pgo

    return _pgo(*args, **kwargs)
