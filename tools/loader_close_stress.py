#!/usr/bin/env python3
"""Stall check of the native flow loader's close (``voldor_tpu_torch/native``)
in one or more checkouts of the repo. For each checkout, a process of its
own started there writes 8 small .flo files into a temporary directory of
that checkout, then opens the loader, reads every file and closes it, up to
2,000 times, on a thread. A cycle that has not ended 20 s after the start is
a stall: the close is waiting for a worker that missed its wake-up. Three
trials a checkout. Prints each trial's cycles and whether it stalled.

    python3 tools/loader_close_stress.py DIR [DIR ...]
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

CHILD = """
import json, os, shutil, sys, tempfile, threading
sys.path.insert(0, '.')
import numpy as np
from voldor_tpu_torch.native.io import NativeFlowDir
from voldor_tpu_torch.utils.flow_io import save_flow

d = tempfile.mkdtemp(prefix='_loader_stress_', dir='.')
for i in range(8):
    save_flow(os.path.join(d, f'{i:06d}.flo'), np.zeros((4, 4, 2), np.float32))
done = []

def cycles():
    for _ in range(2000):
        src = NativeFlowDir(d, n_threads=2)
        for i in range(8):
            src.get(i)
        src.close()
        done.append(src.native)

t = threading.Thread(target=cycles, daemon=True)
t.start()
t.join(20)
print('[stress] ' + json.dumps(dict(cycles=len(done), stalled=t.is_alive(), native=all(done))),
      flush=True)
shutil.rmtree(d, ignore_errors=True)
os._exit(0)
"""


def main():
    for root in sys.argv[1:]:
        runs = []
        for _ in range(3):
            out = subprocess.run([sys.executable, "-c", CHILD], cwd=Path(root).resolve(),
                                 capture_output=True, text=True, timeout=120)
            line = [x for x in out.stdout.splitlines() if x.startswith("[stress] ")]
            if out.returncode != 0 or not line:
                raise SystemExit(f"{root}: the stress child failed: {out.stderr[-2000:]}")
            runs.append(json.loads(line[0][len("[stress] "):]))
        print(f"[loader-close] {root}: {json.dumps(runs)}", flush=True)


if __name__ == "__main__":
    main()
