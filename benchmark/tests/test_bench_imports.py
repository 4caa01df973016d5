"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level name (the port's name begins with the JAX package's), and
the plain reference loads nothing of the port."""

import ast
import subprocess
import sys

import pytest

from bench_support import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "voldor_tpu"}
REFERENCE = ("reference.py", "scene.py")


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix() for p in BENCH.rglob("*.py")
                                        if "tests" not in p.parts))
def test_no_source_of_the_harness_names_jax_or_the_jax_package(path):
    assert not (_top_level_imports(BENCH / path) & FORBIDDEN)


@pytest.mark.parametrize("path", REFERENCE)
def test_the_reference_imports_only_numpy_and_its_own_scene(path):
    assert _top_level_imports(BENCH / path) <= {"__future__", "numpy", "scene"}


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={"PYTHONPATH": f"{BENCH}:{ROOT}", "PATH": "/usr/bin:/bin",
                                           "HOME": str(ROOT), "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_a_run_loads_no_jax_module():
    code = ("import sys, run, calibrate, layers, tracing, reference, scene\n"
            "from roofline import counts\n"
            "import voldor_tpu_torch.slam.system\n"
            "cell = run.Cell(run.BENCH.parent, 'kitti-stereo.stream')\n"
            "for m in run.BENCH.glob('metrics/*.py'): cell.metric_reader(m.stem)\n"
            "for d in run.BENCH.glob('drivers/*.py'): run.load_module(d, 'd_' + d.stem)\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    tops = _modules_after(code)
    assert "voldor_tpu_torch" in tops
    assert not (tops & FORBIDDEN), tops & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    tops = _modules_after("import sys, reference, scene\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not ({"voldor_tpu_torch", "torch"} | FORBIDDEN) & tops
