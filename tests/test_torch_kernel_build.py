"""The seam of the hand-written CUDA kernels, on the CPU: how
`ops/kernels/build.py` names a library and calls its entry points, and
which code the kernel modules share (`ops/kernels/packing.py`) rather than
reach into each other for.  The kernels themselves build and run only on a
card (`tests/test_torch_kernels_cuda.py`, `tests/test_torch_up_cell_cuda.py`).
"""
import ast
import ctypes
import os
import shutil
import types

import pytest
import torch

from uncltmo_tpu_torch.ops.kernels import build

KERNELS = os.path.dirname(build.__file__)
SOURCES = ("double_conv3x3.cu", "double_conv3x3_bf16.cu", "up_cell.cu")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of `csrc/` that `build` reads in place of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", str(copy))
    return copy


def test_each_kernel_is_one_source_over_the_shared_header():
    assert sorted(n for n in os.listdir(build.CSRC) if n.endswith(".cu")) \
        == sorted(SOURCES)
    for source in SOURCES:
        names = {os.path.basename(p) for p in build.source_files(source)}
        assert "hopper.cuh" in names, source
        assert ("double_conv3x3.cuh" in names) == source.startswith(
            "double_conv3x3"), source


# (file edited, sources whose library must change)
EDITS = [("hopper.cuh", SOURCES),
         ("double_conv3x3.cuh", SOURCES[:2]),
         ("double_conv3x3_bf16.cu", SOURCES[1:2]),
         ("up_cell.cu", SOURCES[2:])]


@pytest.mark.parametrize("edited,changed", EDITS, ids=[e for e, _ in EDITS])
def test_library_path_follows_the_source_and_its_headers(csrc, edited,
                                                         changed):
    before = {s: build.library_path(s) for s in SOURCES}
    assert len(set(before.values())) == len(SOURCES)
    with open(csrc / edited, "a") as f:
        f.write("// edited\n")
    after = {s: build.library_path(s) for s in SOURCES}
    assert {s for s in SOURCES if after[s] != before[s]} == set(changed)
    for s in SOURCES:
        assert os.path.basename(after[s]).startswith(
            os.path.splitext(s)[0] + "-")


def test_a_copy_of_a_source_elsewhere_hashes_the_headers_of_csrc(csrc,
                                                                  tmp_path):
    copy = tmp_path / "parent.cu"
    shutil.copy(csrc / "up_cell.cu", copy)
    before = build.library_path(str(copy))
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("// edited\n")
    assert build.library_path(str(copy)) != before


def _lib(*returns):
    """A stand-in for a loaded library: entry points that record their
    arguments and return `returns` in turn."""
    seen, out = [], list(returns)

    def entry(*args):
        seen.append(args)
        return out.pop(0)

    def error_string(err):
        return f"error {err}".encode()
    entry.argtypes = error_string.argtypes = None   # as ctypes starts them
    return types.SimpleNamespace(uncltmo_entry=entry,
                                 uncltmo_cuda_error_string=error_string), seen


def test_call_binds_an_entry_point_by_its_arguments_kinds():
    lib, seen = _lib(0, 0)
    x = torch.zeros(3)
    plan = (ctypes.c_int * 4)()
    build.call(lib, "uncltmo_entry", x, 7, 0.5, plan)
    assert lib.uncltmo_entry.argtypes == [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_float, type(plan)]
    assert lib.uncltmo_entry.restype is ctypes.c_int
    assert seen == [(x.data_ptr(), 7, 0.5, plan)]
    build.call(lib, "uncltmo_entry", x, 8, 0.25, plan)
    assert seen[1][1:3] == (8, 0.25)


def test_call_raises_with_the_librarys_error_string():
    lib, _ = _lib(1)
    with pytest.raises(RuntimeError, match="uncltmo_entry failed: error 1"):
        build.call(lib, "uncltmo_entry", 3)


def _imports(name):
    with open(os.path.join(KERNELS, name)) as f:
        tree = ast.parse(f.read())
    return [(node.module, alias.name) for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) and node.module
            for alias in node.names]


@pytest.mark.parametrize("name", sorted(
    n for n in os.listdir(KERNELS) if n.endswith(".py")))
def test_kernel_modules_import_no_private_name_of_another(name):
    """A kernel module's own private modules (K1's `_concat_skip_triton`)
    are imported from the package; no private name of another module."""
    own = "uncltmo_tpu_torch.ops.kernels." + name[:-3]
    for module, imported in _imports(name):
        if module.startswith("uncltmo_tpu_torch.ops.kernels.") \
                and module != own:
            assert not imported.startswith("_"), (name, module, imported)


def test_up_cell_imports_nothing_of_k2():
    assert not [m for m, _ in _imports("up_cell.py")
                if m.endswith(".double_conv")]
