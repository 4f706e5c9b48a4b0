"""The wheel: it builds offline from a copy of the sources, carries the
port's kernel and native sources and its entry points, and an installed ``ggnn_torch`` builds
its libraries under ``$GGNN_TORCH_CACHE`` or in the temporary directory,
never inside the installed tree.
"""

import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

from ggnn_torch.utils import cache

REPO = Path(__file__).resolve().parents[1]
SOURCES = {"ggnn_torch/csrc/adjacency_dot.cu",
           "ggnn_torch/entry.py",
           "ggnn_torch/native/src/ggnn_native.cpp",
           "ggnn_tpu/native/src/ggnn_native.cpp"}

# in the installed copy: where the native library lands (built with g++)
PROBE = """
import sys, tempfile
import ggnn_torch
from ggnn_torch.native import build
print(ggnn_torch.__file__)
print(tempfile.gettempdir())
print(build.load() is not None)
print(build.library_path())
"""


@pytest.fixture(scope="module")
def installed(tmp_path_factory):
    """A wheel built from a copy of the sources (``pip wheel`` writes
    ``build/`` and ``*.egg-info`` into the tree it builds), installed into a
    target directory."""
    src = tmp_path_factory.mktemp("src")
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(REPO / name, src / name)
    for name in ("ggnn_tpu", "ggnn_torch"):
        shutil.copytree(REPO / name, src / name,
                        ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    dist = tmp_path_factory.mktemp("dist")
    subprocess.run([sys.executable, "-m", "pip", "wheel", "--no-build-isolation",
                    "--no-deps", "--no-index", "-w", str(dist), str(src)],
                   check=True, capture_output=True, text=True, timeout=300)
    wheel = next(dist.glob("*.whl"))
    target = tmp_path_factory.mktemp("site")
    subprocess.run([sys.executable, "-m", "pip", "install", "--no-deps",
                    "--no-index", "--target", str(target), str(wheel)],
                   check=True, capture_output=True, text=True, timeout=300)
    return wheel, target


def test_wheel_carries_the_sources(installed):
    wheel, target = installed
    names = set(zipfile.ZipFile(wheel).namelist())
    assert SOURCES <= names
    assert "bench_torch.py" not in names and "chip_smoke.py" not in names
    for name in SOURCES:
        assert (target / name).is_file()


@pytest.mark.parametrize("where", ["temp_default", "GGNN_TORCH_CACHE"])
def test_installed_package_builds_outside_its_tree(installed, tmp_path, where):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native library")
    _, target = installed
    env = {k: v for k, v in os.environ.items()
           if k not in ("GGNN_TORCH_CACHE", "GGNN_TORCH_NO_NATIVE", "PYTHONPATH")}
    env["PYTHONPATH"] = str(target)
    env["TMPDIR"] = str(tmp_path / "tmp")
    (tmp_path / "tmp").mkdir()
    want = tmp_path / "tmp" / "ggnn_torch"
    if where == "GGNN_TORCH_CACHE":
        want = tmp_path / "libs"
        env["GGNN_TORCH_CACHE"] = str(want)
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    module, tmp, built, library = proc.stdout.split("\n")[:4]
    assert Path(module).resolve().is_relative_to(target.resolve())
    assert Path(tmp) == tmp_path / "tmp"
    assert built == "True"
    assert Path(library).parent == want and Path(library).is_file()
    assert not list(target.rglob("*.so"))


def test_source_checkout_keeps_build_kernels(monkeypatch):
    monkeypatch.delenv("GGNN_TORCH_CACHE", raising=False)
    assert cache.cache_dir() == REPO / "build" / "kernels"
    monkeypatch.setenv("GGNN_TORCH_CACHE", "/elsewhere")
    assert cache.cache_dir() == Path("/elsewhere")
