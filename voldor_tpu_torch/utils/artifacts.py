"""Provenance stamps for committed measurement records (a copy of
``voldor_tpu/utils/artifacts.py``): the git revision and the UTC time a
record was measured at, so a stale record can be told by inspection.
"""

from __future__ import annotations

import os
import subprocess
import time


def git_rev(repo_dir: str | None = None) -> str:
    """Short git revision of the repo, plus '-dirty' when tracked files are
    modified; 'unknown' when git cannot say. Never raises: a measurement
    must not fail for want of provenance."""
    if repo_dir is None:
        repo_dir = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        rev = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=repo_dir, capture_output=True, text=True, timeout=10,
        ).stdout.strip()
        if not rev:
            return "unknown"
        dirty = subprocess.run(
            ["git", "status", "--porcelain", "--untracked-files=no"],
            cwd=repo_dir, capture_output=True, text=True, timeout=10,
        ).stdout.strip()
        return rev + ("-dirty" if dirty else "")
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def stamp(rec: dict, **extra) -> dict:
    """``rec`` with a 'measured_at' block (git_rev, utc and ``extra``)
    prepended."""
    meta = {
        "git_rev": git_rev(),
        "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    meta.update(extra)
    out = {"measured_at": meta}
    out.update(rec)
    return out
