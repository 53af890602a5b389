"""A later change adds a cell, a configuration and a per-layer metric as
new files (and entries in BENCHMARK.json) and edits no file of
`portbench/`: the harness finds each by its name, and refuses by name a
cell whose configuration, driver or metric reader does not exist."""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.conftest import ROOT


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "portbench")):
        for f in files:
            if "__pycache__" in d or ".cache" in d:
                continue
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


@pytest.fixture
def copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return str(root)


def _add(root, rel, text):
    path = os.path.join(root, rel)
    assert not os.path.exists(path), rel
    with open(path, "w") as f:
        f.write(text)


def _bench(root):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _save(root, bench):
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


def test_a_new_cell_config_and_metric_are_found_by_name(copy):
    before = _digests(copy)
    cfg = json.load(open(os.path.join(copy, "portbench", "configs",
                                      "uncltmo_image.json")))
    cfg["name"] = "uncltmo_image_b"
    _add(copy, "portbench/configs/uncltmo_image_b.json", json.dumps(cfg))
    traffic = json.load(open(os.path.join(copy, "portbench", "traffic",
                                          "frames_1080p.json")))
    traffic.update(frames=2, height=264, width=280, warmup=1, compare=1)
    _add(copy, "portbench/traffic/frames_small.json", json.dumps(traffic))
    _add(copy, "portbench/metrics/frames_in_window.py",
         '"""frames_in_window: frames the window delivered."""\n\n\n'
         "def read(run):\n    return run.window.items\n")
    bench = _bench(copy)
    bench["configs"].append(dict(bench["configs"][0], name="uncltmo_image_b",
                                 file="portbench/configs/"
                                      "uncltmo_image_b.json"))
    bench["workloads"].append({"name": "image_small",
                               "config": "uncltmo_image_b",
                               "traffic": "frames_small", "chips": 1,
                               "why": "test"})
    bench["end_to_end"][0]["workloads"].append("image_small")
    bench["per_layer"].append({"name": "frames_in_window", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "frames_per_s",
                               "workloads": ["image_small"]})
    _save(copy, bench)
    after = _digests(copy)
    assert {k: v for k, v in after.items() if k in before} == before

    cell = harness.resolve("image_small", traced=True, root=copy)
    assert cell.config["name"] == "uncltmo_image_b"
    assert cell.traffic["height"] == 264
    assert [m["name"] for m in cell.metrics] == ["frames_in_window"]

    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{copy!r}, {ROOT!r}]\n"
        "from portbench import harness\n"
        "assert harness.ROOT == " + repr(copy) + "\n"
        "sys.exit(harness.main(['--workload', 'image_small', '--seed',"
        " '12', '--seconds', '0.1', '--trace', '1'], time.perf_counter(),"
        " device='cpu'))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=copy)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["frames_in_window"]["value"] >= 1


@pytest.mark.parametrize("what", ["config", "driver", "metric", "traffic"])
def test_unknown_names_are_refused_by_name(copy, what):
    bench = _bench(copy)
    w = bench["workloads"][0]
    if what == "config":
        w["config"] = "no_such_config"
    elif what == "traffic":
        w["traffic"] = "no_such_traffic"
    elif what == "driver":
        _add(copy, "portbench/traffic/odd.json",
             json.dumps({"driver": "no_such_driver"}))
        w["traffic"] = "odd"
    else:
        bench["end_to_end"].append({"name": "no_such_metric", "unit": "s",
                                    "better": "lower", "bound": 0.1,
                                    "source": "host_clock"})
    _save(copy, bench)
    with pytest.raises(ValueError, match=f"no_such_{what}|odd"):
        harness.resolve(w["name"], traced=False, root=copy)
