"""The port's copy of the build-config helpers
(``accvlab_tpu_torch.build_config``): ``tests/test_build_config.py``'s
cases, with the port's libraries built into its own build directory, and
the port's ``g++`` builds taking their flags from ``select_cxx_flags``."""

import os
import subprocess

import shutil

import pytest

from accvlab_tpu_torch._native_build import BUILD_DIR
from accvlab_tpu_torch.build_config import (
    build_cmake_args,
    find_repo_root,
    get_package_version,
    probe_cxx_flag,
    run_external_build,
    select_cxx_flags,
)


def test_find_repo_root_from_package():
    root = find_repo_root()
    assert root is not None
    assert os.path.exists(os.path.join(root, "pyproject.toml"))


def test_find_repo_root_none_outside(tmp_path):
    # a bare temp dir with no markers anywhere up to / (tmp dirs usually
    # have none, but guard against a marker-bearing ancestor)
    result = find_repo_root(str(tmp_path))
    if result is not None:
        assert any(
            os.path.exists(os.path.join(result, m))
            for m in (".accvlab-root", "pyproject.toml", ".git")
        )


def test_version_forwarding():
    v = get_package_version()
    assert isinstance(v, str) and v[0].isdigit()


def test_probe_cxx_flag():
    assert probe_cxx_flag("-O2")
    assert not probe_cxx_flag("--definitely-not-a-flag-xyz")


def test_select_cxx_flags_default_and_env(monkeypatch):
    flags = select_cxx_flags()
    assert "-O3" in flags and "-std=c++17" in flags
    monkeypatch.setenv("ACCVLAB_CXXFLAGS", "-O1 -DFOO=1")
    assert select_cxx_flags() == ["-O1", "-DFOO=1"]


def test_build_cmake_args_env(monkeypatch):
    monkeypatch.setenv("ACCVLAB_CMAKE_BUILD_TYPE", "Debug")
    monkeypatch.setenv("ACCVLAB_CMAKE_ARGS", "-DBAR=2")
    args = build_cmake_args()
    assert "-DCMAKE_BUILD_TYPE=Debug" in args
    assert "-DBAR=2" in args
    assert any(a.startswith("-DACCVLAB_VERSION=") for a in args)


def test_run_external_build_direct_gpp(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "hello.cpp").write_text(
        'extern "C" int accvlab_hello() { return 42; }\n'
    )
    lib = run_external_build(str(csrc), "libhello_port_test")
    assert os.path.exists(lib) and os.path.dirname(lib) == BUILD_DIR
    import ctypes

    assert ctypes.CDLL(lib).accvlab_hello() == 42
    # rebuild is a cache hit (same path), edit changes the key
    assert run_external_build(str(csrc), "libhello_port_test") == lib
    (csrc / "hello.cpp").write_text(
        'extern "C" int accvlab_hello() { return 43; }\n'
    )
    lib2 = run_external_build(str(csrc), "libhello_port_test")
    assert lib2 != lib
    for path in (lib, lib2):
        os.remove(path)


def test_run_external_build_cmake(tmp_path):
    if shutil.which("cmake") is None:
        pytest.skip("cmake not available")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "lib.cpp").write_text('extern "C" int accvlab_cm() { return 7; }\n')
    (csrc / "CMakeLists.txt").write_text(
        "cmake_minimum_required(VERSION 3.16)\n"
        "project(accvlab_cm_test CXX)\n"
        "add_library(accvlab_cm SHARED lib.cpp)\n"
    )
    lib = run_external_build(str(csrc), "libaccvlab_cm_port_test")
    import ctypes

    assert os.path.dirname(lib) == BUILD_DIR
    assert ctypes.CDLL(lib).accvlab_cm() == 7
    os.remove(lib)


def test_host_builds_take_select_cxx_flags(monkeypatch, tmp_path):
    """The port's g++ builds take their flags from select_cxx_flags, as
    accvlab_tpu/_native_build.py does: an override reaches the command."""
    from accvlab_tpu_torch import _native_build

    seen = []
    monkeypatch.setattr(_native_build.subprocess, "run",
                        lambda cmd, **kw: seen.append(cmd) or subprocess.CompletedProcess(
                            cmd, 1, "", "stopped here"))
    monkeypatch.setenv("ACCVLAB_CXXFLAGS", "-O1 -DPORT_TEST=1")
    src = tmp_path / "x.cpp"
    src.write_text("int x;\n")
    with pytest.raises(RuntimeError, match="stopped here"):
        _native_build.build_host_lib(str(src), "libport_flags_test")
    assert seen[0][:4] == ["g++", "-O1", "-DPORT_TEST=1", "-shared"]
