"""Build-policy helpers (a copy of ``accvlab_tpu/build_config/helpers.py``;
see the package docstring). The port's builds go to its own build directory,
``accvlab_tpu_torch/_build/``, never into a ``csrc/`` directory nor a user
cache."""

from __future__ import annotations

import functools
import hashlib
import os
import shlex
import subprocess
import tempfile
from typing import List, Optional

_ROOT_MARKERS = (".accvlab-root", "pyproject.toml", ".git")


def find_repo_root(start: Optional[str] = None) -> Optional[str]:
    """Walk up from ``start`` (default: this file) until a repo marker is
    found (parity: the reference's ``.nav``-marker discovery,
    ``cmake_args.py:14-40``). Returns None when no marker exists up to /."""
    d = os.path.abspath(start or os.path.dirname(__file__))
    if os.path.isfile(d):
        d = os.path.dirname(d)
    while True:
        if any(os.path.exists(os.path.join(d, m)) for m in _ROOT_MARKERS):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return None
        d = parent


def get_package_version() -> str:
    """Version forwarding (parity: setuptools-scm forwarding,
    ``cmake_args.py:176``): installed distribution metadata first, then the
    in-tree ``pyproject.toml``, then a dev fallback."""
    try:
        from importlib.metadata import version

        return version("accvlab-tpu")
    except Exception:
        pass
    root = find_repo_root()
    if root:
        pyproject = os.path.join(root, "pyproject.toml")
        if os.path.exists(pyproject):
            try:
                import tomllib

                with open(pyproject, "rb") as f:
                    v = tomllib.load(f).get("project", {}).get("version")
                if v:
                    return str(v)
            except Exception:
                pass
    return "0.0.0.dev0"


@functools.lru_cache(maxsize=None)
def probe_cxx_flag(flag: str, compiler: str = "g++") -> bool:
    """True when ``compiler`` accepts ``flag`` for a trivial translation unit
    (the host analog of nvcc arch probing, ``build_utils.py:119`` — what
    the reference does for compute capabilities, done for host ISA/opt
    flags)."""
    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, "probe.cpp")
        with open(src, "w") as f:
            f.write("int main() { return 0; }\n")
        res = subprocess.run(
            [compiler, flag, "-fsyntax-only", src],
            capture_output=True,
            text=True,
        )
        return res.returncode == 0


def select_cxx_flags(extra: Optional[List[str]] = None) -> List[str]:
    """Optimization/ISA flags for native builds.

    ``ACCVLAB_CXXFLAGS`` overrides everything (parity: the reference's
    env-var-driven cmake args). Otherwise: ``-O3 -std=c++17 -fPIC`` plus
    probed niceties (``-march=native`` unless ``ACCVLAB_PORTABLE=1``).
    """
    env = os.environ.get("ACCVLAB_CXXFLAGS")
    if env is not None:
        return shlex.split(env)
    flags = ["-O3", "-std=c++17", "-fPIC"]
    if os.environ.get("ACCVLAB_DEBUG") == "1":
        flags = ["-Og", "-g", "-std=c++17", "-fPIC"]
    if os.environ.get("ACCVLAB_PORTABLE") != "1" and probe_cxx_flag("-march=native"):
        flags.append("-march=native")
    return flags + list(extra or [])


def build_cmake_args(install_prefix: Optional[str] = None) -> List[str]:
    """Env-var-driven cmake arguments (parity: ``build_cmake_args``,
    ``cmake_args.py:195``): build type, version forwarding, generator
    selection, free-form ``ACCVLAB_CMAKE_ARGS`` passthrough."""
    args = [
        f"-DCMAKE_BUILD_TYPE={os.environ.get('ACCVLAB_CMAKE_BUILD_TYPE', 'Release')}",
        f"-DACCVLAB_VERSION={get_package_version()}",
        "-DCMAKE_POSITION_INDEPENDENT_CODE=ON",
    ]
    if install_prefix:
        args.append(f"-DCMAKE_INSTALL_PREFIX={install_prefix}")
    gen = os.environ.get("ACCVLAB_CMAKE_GENERATOR")
    if gen is None and _have("ninja"):
        gen = "Ninja"
    if gen:
        args += ["-G", gen]
    extra = os.environ.get("ACCVLAB_CMAKE_ARGS")
    if extra:
        args += shlex.split(extra)
    return args


def _have(tool: str) -> bool:
    from shutil import which

    return which(tool) is not None


def _tree_digest(src_dir: str) -> str:
    h = hashlib.sha256()
    for root, _, files in sorted(os.walk(src_dir)):
        for name in sorted(files):
            if name.endswith((".cpp", ".cc", ".h", ".hpp", ".txt", ".cmake")):
                p = os.path.join(root, name)
                h.update(name.encode())
                with open(p, "rb") as f:
                    h.update(f.read())
    return h.hexdigest()[:12]


def run_external_build(
    csrc_dir: str,
    target_stem: str,
    link_args: Optional[List[str]] = None,
) -> str:
    """Build a package's native code and return the shared-library path
    (parity: ``run_external_build``, ``build_utils.py:387`` — the reference
    drives each package's ``ext_impl`` cmake; here, cmake when the package
    ships a ``CMakeLists.txt``, direct ``g++`` otherwise), into the port's
    build directory.

    Outputs are keyed on a content hash of the source tree, so checkouts and
    edits can never load a stale binary.
    """
    csrc_dir = os.path.abspath(csrc_dir)
    cmakelists = os.path.join(csrc_dir, "CMakeLists.txt")
    if not os.path.exists(cmakelists):
        sources = [
            f for f in sorted(os.listdir(csrc_dir)) if f.endswith((".cpp", ".cc"))
        ]
        if len(sources) != 1:
            raise RuntimeError(
                f"{csrc_dir}: direct build needs exactly one source file "
                f"(found {sources}); add a CMakeLists.txt for multi-file builds"
            )
        from .._native_build import build_host_lib

        return build_host_lib(os.path.join(csrc_dir, sources[0]), target_stem, link_args)

    from .._native_build import BUILD_DIR

    digest = _tree_digest(csrc_dir)
    out_base = BUILD_DIR
    os.makedirs(out_base, exist_ok=True)
    lib_path = os.path.join(out_base, f"{target_stem}-{digest}.so")
    if os.path.exists(lib_path):
        return lib_path
    # pid-suffixed build dir + atomic publish: concurrent first-use builders
    # must not share object files or install a partially linked library
    build_dir = os.path.join(out_base, f".build-{target_stem}-{digest}-{os.getpid()}")
    os.makedirs(build_dir, exist_ok=True)
    try:
        cfg = subprocess.run(
            ["cmake", csrc_dir, *build_cmake_args()],
            cwd=build_dir,
            capture_output=True,
            text=True,
        )
        if cfg.returncode != 0:
            raise RuntimeError(f"cmake configure failed:\n{cfg.stderr[-2000:]}")
        bld = subprocess.run(
            ["cmake", "--build", ".", "--parallel"],
            cwd=build_dir,
            capture_output=True,
            text=True,
        )
        if bld.returncode != 0:
            # ninja streams compile errors to stdout; include both
            raise RuntimeError(
                f"cmake build failed:\n{bld.stdout[-2000:]}\n{bld.stderr[-2000:]}"
            )
        # prefer the library matching the requested stem; error on ambiguity
        produced = [
            os.path.join(r, f)
            for r, _, fs in os.walk(build_dir)
            for f in fs
            if f.endswith(".so")
        ]
        if not produced:
            raise RuntimeError(f"cmake build produced no shared library in {build_dir}")
        named = [
            p for p in produced
            if target_stem.removeprefix("lib") in os.path.basename(p)
        ]
        if len(produced) > 1 and len(named) != 1:
            raise RuntimeError(
                f"cmake build produced multiple libraries {produced}; none/"
                f"several match target_stem={target_stem!r}"
            )
        os.replace(named[0] if named else produced[0], lib_path)  # atomic
        return lib_path
    finally:
        import shutil

        shutil.rmtree(build_dir, ignore_errors=True)
