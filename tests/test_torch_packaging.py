"""The port's package data: an installed ``quattro_tpu_torch`` carries every file it builds or reads.

The kernels are compiled from ``csrc/`` at first use (``ops/_build.py``), the
shard IO's native library from ``io/shardio.cpp``, and the MuJoCo bridges read
``sim/assets/*.xml``; none of these is a Python module, so a wheel holds them
only where ``pyproject.toml``'s package-data globs name them.
"""

import fnmatch
import pathlib
import re
import tomllib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "quattro_tpu_torch"


def globs():
    with open(ROOT / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["tool"]["setuptools"]["package-data"]["quattro_tpu_torch"]


def ships(relative: str) -> bool:
    # setuptools matches a glob per directory: "csrc/*.cu" does not reach into a subdirectory.
    return any(fnmatch.fnmatch(relative, g) and relative.count("/") == g.count("/") for g in globs())


def data_files():
    out = []
    for folder in ("csrc", "io", "sim/assets"):
        out += [p for p in sorted((PACKAGE / folder).rglob("*")) if p.is_file() and p.suffix not in (".py", ".pyc")]
    return out


def test_the_data_folders_hold_what_the_port_builds():
    names = {p.relative_to(PACKAGE).as_posix() for p in data_files()}
    assert {"csrc/plants.cuh", "csrc/host_derivatives.cpp", "io/shardio.cpp", "sim/assets/cartpole.xml",
            "sim/assets/quadrotor.xml"} <= names
    assert sum(n.endswith(".cuh") for n in names) == 6 and sum(n.endswith(".cu") for n in names) == 8


@pytest.mark.parametrize("path", data_files(), ids=lambda p: p.relative_to(PACKAGE).as_posix())
def test_every_data_file_ships(path):
    assert ships(path.relative_to(PACKAGE).as_posix()), f"{path.relative_to(ROOT)} is not in the package data"


INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


@pytest.mark.parametrize("path", sorted((PACKAGE / "csrc").glob("*.cu*")), ids=lambda p: p.name)
def test_every_local_include_ships(path):
    """Each ``#include "..."`` of a kernel source names a file of ``csrc/`` that the globs carry."""
    for name in INCLUDE.findall(path.read_text()):
        target = (path.parent / name).resolve()
        assert target.is_file(), f"{path.name} includes {name}, which is not in csrc/"
        assert ships(target.relative_to(PACKAGE).as_posix()), f"{path.name} includes {name}, which does not ship"
