"""The PyTorch port runs once installed. ``pyproject.toml``'s package data
ships every file the port's builds read; a wheel built from a copy of the
checkout, unpacked outside it (its files left untouched, ``HOME`` in a
temporary directory, ``jax`` and ``pandaseq_tpu`` unimportable), runs the
port's CLI on the CPU with the JAX CLI's bytes, builds the native host
library under ``~/.cache/pandaseq_tpu_torch`` (or ``PANDASEQ_TPU_CACHE``)
and writes nothing into its install directory. Without the host engine's
source the engine raises and names it; ``scale_run`` outside a checkout
and without ``--input`` exits naming ``--input``."""

import fnmatch
import glob
import os
import shutil
import subprocess
import sys
import tomllib
import zipfile

import pytest

from pandaseq_tpu_torch.io import native
from pandaseq_tpu_torch.ops import _build
from tests.test_torch_cli import BASE, ENV, ROOT, run_module
from tests.test_torch_nojax import _BLOCK

PKG = os.path.join(ROOT, "pandaseq_tpu_torch")
# the files the port's builds open at run time, relative to the package
RUNTIME_FILES = sorted(
    [os.path.relpath(os.path.join(_build._CSRC, name), PKG)
     for name in os.listdir(_build._CSRC)
     if name.endswith((".cu", ".cuh"))]
    + [os.path.relpath(native._SRC, PKG)])


def _pyproject():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as fh:
        return tomllib.load(fh)


@pytest.mark.parametrize("rel", RUNTIME_FILES)
def test_package_data_ships_what_the_builds_read(rel):
    globs = _pyproject()["tool"]["setuptools"]["package-data"][
        "pandaseq_tpu_torch"]
    assert os.path.isfile(os.path.join(PKG, rel))
    assert any(fnmatch.fnmatch(rel, g) for g in globs), (rel, globs)


def test_runtime_files_cover_the_sources():
    """The list the test above is parametrised over holds every kernel
    source, the header they share and the host engine's source."""
    assert set(RUNTIME_FILES) >= {
        *("csrc/" + s for s in _build.SOURCES), "csrc/join.cuh",
        "native/psq_io.cpp"}


def test_torch_install_needs_no_jax():
    project = _pyproject()["project"]
    reqs = project["dependencies"] + \
        project["optional-dependencies"]["torch"]
    assert not [r for r in reqs if r.split()[0].startswith("jax")], reqs
    assert project["optional-dependencies"]["jax"] == ["jax"]


def _snapshot(root):
    """Every path under ``root`` with its size and mtime."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        for name in dirnames + filenames:
            path = os.path.join(dirpath, name)
            st = os.lstat(path)
            out[os.path.relpath(path, root)] = (st.st_size, st.st_mtime_ns)
    return out


def _read_only(root):
    for dirpath, _, filenames in os.walk(root):
        for name in filenames:
            os.chmod(os.path.join(dirpath, name), 0o444)
        os.chmod(dirpath, 0o555)


def _writable(root):
    for dirpath, _, filenames in os.walk(root):
        os.chmod(dirpath, 0o755)
        for name in filenames:
            os.chmod(os.path.join(dirpath, name), 0o644)


@pytest.fixture(scope="module")
def installed(tmp_path_factory):
    """(the wheel, its unpacked read-only site directory, the directory
    of a sitecustomize that blocks jax and pandaseq_tpu)."""
    tmp = tmp_path_factory.mktemp("install")
    src = tmp / "src"
    src.mkdir()
    skip = shutil.ignore_patterns("__pycache__", "*.so", "*.pyc")
    for name in ("pandaseq_tpu", "pandaseq_tpu_torch"):
        shutil.copytree(os.path.join(ROOT, name), src / name, ignore=skip)
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(os.path.join(ROOT, name), src)
    got = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-build-isolation",
         "--no-deps", "--no-index", "-q", "-w", str(tmp / "dist"),
         str(src)], capture_output=True, timeout=300)
    assert got.returncode == 0, got.stderr.decode()[-3000:]
    (wheel,) = glob.glob(str(tmp / "dist" / "*.whl"))
    site = tmp / "site"
    with zipfile.ZipFile(wheel) as zf:
        zf.extractall(site)
    _read_only(site)
    block = tmp / "block"
    block.mkdir()
    (block / "sitecustomize.py").write_text(_BLOCK)
    yield wheel, site, block
    _writable(site)


def _installed_env(site, block, home, **extra):
    env = {k: v for k, v in ENV.items() if k != "PANDASEQ_TPU_CACHE"}
    env.update(PYTHONPATH="%s%s%s" % (block, os.pathsep, site),
               HOME=str(home), PYTHONDONTWRITEBYTECODE="1", **extra)
    return env


def test_wheel_ships_the_port_sources(installed):
    wheel = installed[0]
    with zipfile.ZipFile(wheel) as zf:
        names = set(zf.namelist())
        (meta,) = [n for n in names if n.endswith(".dist-info/METADATA")]
        requires = [ln.split(":", 1)[1].strip()
                    for ln in zf.read(meta).decode().splitlines()
                    if ln.startswith("Requires-Dist:")]
    for rel in RUNTIME_FILES:
        assert "pandaseq_tpu_torch/" + rel in names
    # jax only under its extra
    assert [r for r in requires if r.startswith("jax")] == \
        ['jax; extra == "jax"']


_WANT = {}


def _want(extra):
    """(the JAX CLI's stdout, the port CLI's from the checkout)."""
    key = tuple(extra)
    if key not in _WANT:
        jax_run = run_module("pandaseq_tpu.cli.main", BASE + extra)
        port_run = run_module("pandaseq_tpu_torch", BASE + extra)
        assert jax_run.returncode == 0 and jax_run.stdout
        assert port_run.returncode == 0
        _WANT[key] = jax_run.stdout, port_run.stdout
    return _WANT[key]


@pytest.mark.parametrize("where,extra", [("home", []), ("home", ["-k", "0"]),
                                         ("cache", [])])
def test_installed_cli_equals_jax_cli(installed, tmp_path, where, extra):
    """From a temporary cwd, with only the unpacked wheel on the path:
    stdout byte-equal to the JAX CLI's and to the checkout's port run;
    the native library built under ``$HOME/.cache/pandaseq_tpu_torch``,
    or under ``PANDASEQ_TPU_CACHE`` when that is set; nothing written in
    the site directory."""
    _, site, block = installed
    home, cwd, cache = tmp_path / "home", tmp_path / "cwd", tmp_path / "c"
    home.mkdir()
    cwd.mkdir()
    extra_env = {"PANDASEQ_TPU_CACHE": str(cache)} if where == "cache" \
        else {}
    before = _snapshot(site)
    got = subprocess.run(
        [sys.executable, "-m", "pandaseq_tpu_torch", *BASE, *extra],
        capture_output=True, cwd=cwd, timeout=300,
        env=_installed_env(site, block, home, **extra_env))
    assert got.returncode == 0, got.stderr.decode()[-3000:]
    jax_out, port_out = _want(extra)
    assert got.stdout == jax_out == port_out
    root = cache if where == "cache" else \
        home / ".cache" / "pandaseq_tpu_torch"
    assert glob.glob(str(root / "native" / "_psq_io-*.so"))
    if where == "cache":
        assert not (home / ".cache").exists()
    assert os.listdir(cwd) == []
    assert _snapshot(site) == before


def test_installed_cli_names_the_missing_source(installed, tmp_path):
    """An install without the host engine's source: the CLI prints no
    record and its ERR DEVICE line names the missing file."""
    _, site, block = installed
    bare = tmp_path / "site"
    shutil.copytree(site, bare)
    _writable(bare)
    os.remove(bare / "pandaseq_tpu_torch" / "native" / "psq_io.cpp")
    got = subprocess.run(
        [sys.executable, "-m", "pandaseq_tpu_torch", *BASE],
        capture_output=True, cwd=tmp_path, timeout=300,
        env=_installed_env(bare, block, tmp_path))
    assert got.returncode == 1 and got.stdout == b""
    err = got.stderr.decode()
    assert "ERR\tDEVICE" in err
    assert str(bare / "pandaseq_tpu_torch" / "native" / "psq_io.cpp") in err


@pytest.mark.parametrize("fault", ["missing", "broken"])
def test_engine_raises_with_the_build_error(tmp_path, monkeypatch, fault):
    """Without a library the engine raises with the reason: the missing
    source's path, or g++'s error on a source that does not compile."""
    from pandaseq_tpu_torch.assembler import BatchAssembler

    src = tmp_path / "psq_io.cpp"
    if fault == "broken":
        src.write_text("int psq_open_pair( {\n")
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PANDASEQ_TPU_CACHE", str(tmp_path / "cache"))
    with pytest.raises(RuntimeError) as info:
        BatchAssembler(device="cpu")
    msg = str(info.value)
    assert msg.startswith("the native host library did not build: ")
    assert str(src) in msg
    if fault == "missing":
        assert "missing" in msg
    else:
        assert "g++ failed" in msg and "error" in msg
    assert native.build_error in msg


def test_scale_run_outside_a_checkout_needs_input(installed, tmp_path):
    """No generator beside the installed package: without --input
    scale_run exits nonzero naming --input, with no traceback."""
    _, site, block = installed
    got = subprocess.run(
        [sys.executable, "-m", "pandaseq_tpu_torch.scale_run", "--procs",
         "2", "--device", "cpu"], capture_output=True, cwd=tmp_path,
        timeout=120, env=_installed_env(site, block, tmp_path))
    err = got.stderr.decode()
    assert got.returncode != 0
    assert "--input" in err and "Traceback" not in err
    assert got.stdout == b""
