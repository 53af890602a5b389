"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference imports nothing of the program under test.  Module names are
compared by their whole top-level name: `uncltmo_tpu_torch` is not
`uncltmo_tpu`."""
from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys

from portbench import harness
from portbench.tests.conftest import ROOT

BENCH = os.path.join(ROOT, "portbench")


def _python(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_whole_run_of_every_cell_loads_no_jax():
    """A CPU run of every cell, traced, in a fresh process: afterwards no
    module of sys.modules has a forbidden top-level name, and the port
    was loaded (so the check would have seen it)."""
    got = _python(
        "import json, sys, contextlib, io\n"
        "sys.path.insert(0, '.')\n"
        "from portbench.tests.conftest import cpu_run, SMALL\n"
        "from portbench import harness\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    for name in SMALL:\n"
        "        cpu_run(name, traced=False)\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'forbidden': harness.loaded_forbidden(),"
        " 'tops': tops}))\n")
    assert got["forbidden"] == []
    assert "uncltmo_tpu_torch" in got["tops"]
    assert not {"jax", "jaxlib", "flax", "uncltmo_tpu"} & set(got["tops"])


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "uncltmo_tpu_torch_probe", sys)
    assert "uncltmo_tpu" not in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "uncltmo_tpu.probe", sys)
    assert "uncltmo_tpu" in harness.loaded_forbidden()


def _imported(path: str) -> set:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(BENCH, "reference", "*.py"))
    assert files
    for path in files:
        bad = _imported(path) & {"uncltmo_tpu_torch", "uncltmo_tpu", "jax",
                                 "jaxlib", "flax"}
        assert not bad, (path, bad)
    got = _python(
        "import json, sys\n"
        "sys.path.insert(0, '.')\n"
        "import portbench.reference.unet, portbench.reference.pipeline\n"
        "import portbench.reference.hdrio\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not {"uncltmo_tpu_torch", "uncltmo_tpu", "jax"} & set(got)


def test_no_file_of_the_benchmark_imports_jax():
    for path in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True):
        assert not _imported(path) & {"jax", "jaxlib", "flax",
                                      "uncltmo_tpu"}, path
