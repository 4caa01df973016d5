"""Shared fixtures and helpers of the benchmark's own tests (run with
``python -m pytest benchmark/tests``; the repository's ``tests/`` does not
collect them). Importing it puts ``benchmark/`` and the repository's root
on the path."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """Skips a test that needs a CUDA device where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark measures the card)")
    return torch.device("cuda")


def tiny_root(tmp_path: Path, w: int, h: int, user_config: str) -> Path:
    """A root whose BENCHMARK.json is the repository's, with every
    configuration cut to w x h (intrinsics scaled): the same cells, mixes,
    metrics and limits, small enough for the CPU."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in manifest["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        s = w / cfg["w"]
        cfg.update(w=w, h=h, fx=cfg["fx"] * s, fy=cfg["fy"] * s, cx=cfg["cx"] * s,
                   cy=cfg["cy"] * h / cfg["h"], voldor_user_config=user_config)
        if "bf" in cfg:
            cfg["bf"] *= s
        f = tmp_path / f"{c['name']}.json"
        f.write_text(json.dumps(cfg))
        c["file"] = str(f)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp_path


TINY_CONFIG = "--n_poses_to_sample 1024 --depth_rand_samples 4"


@pytest.fixture
def tiny(tmp_path):
    return tiny_root(tmp_path, 96, 32, TINY_CONFIG)


@pytest.fixture
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
