"""Lazy builds of the port's native code into ``accvlab_tpu_torch/_build/``.

* host C++ (``*.cpp``): ``g++`` with :func:`.build_config.select_cxx_flags`
  (``-O3 -std=c++17 -fPIC -march=native`` unless ``ACCVLAB_CXXFLAGS``,
  ``ACCVLAB_DEBUG`` or ``ACCVLAB_PORTABLE`` say otherwise) and ``-shared``;
  the JPEG decoder links libjpeg (:func:`libjpeg_link`);
* CUDA (``*.cu``): ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
  -Xcompiler -fPIC`` into a shared library with a plain C interface, loaded
  with ``ctypes`` by the caller.

Outputs are named by a hash of the source, the local headers and the flags,
so a library can never be stale. Builds go to the port's own gitignored
build directory only, never into a ``csrc/`` directory.
"""

from __future__ import annotations

import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import List, Optional

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

#: seconds spent in the compiler by the last build of each library stem
build_seconds: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc``
    or ``nvcc`` on ``PATH``. Raises ``RuntimeError`` when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.exists(c):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: CUDA kernels cannot be built on this host")
    return found


def _digest(src: str, flags: List[str]) -> str:
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    src_dir = os.path.dirname(os.path.abspath(src))
    for hdr in sorted(glob.glob(os.path.join(src_dir, "*.h"))
                      + glob.glob(os.path.join(src_dir, "*.cuh"))):
        with open(hdr, "rb") as f:
            h.update(os.path.basename(hdr).encode())
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:12]


def _build(cmd_prefix: List[str], src: str, stem: str, flags: List[str],
           link_args: List[str]) -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"{stem}-{_digest(src, flags + link_args)}.so")
    if os.path.exists(lib_path):
        return lib_path
    tmp_path = f"{lib_path}.tmp{os.getpid()}"
    cmd = cmd_prefix + flags + ["-o", tmp_path, src] + link_args
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds[stem] = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(
            f"{stem} build failed ({' '.join(cmd)}):\n{res.stdout[-2000:]}{res.stderr[-4000:]}"
        )
    os.replace(tmp_path, lib_path)  # atomic: concurrent builds race safely
    return lib_path


def build_host_lib(src: str, stem: str, link_args: Optional[List[str]] = None,
                   extra_flags: Optional[List[str]] = None) -> str:
    """Compile host C++ ``src`` into ``_build/<stem>-<hash>.so``; returns the path."""
    from .build_config import select_cxx_flags

    return _build(["g++"], src, stem, select_cxx_flags() + ["-shared"] + list(extra_flags or []),
                  list(link_args or []))


def _ldconfig_libjpeg62() -> Optional[str]:
    """The path ``ldconfig -p`` lists for ``libjpeg.so.62``, or None."""
    try:
        res = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True)
    except OSError:
        return None
    for line in res.stdout.splitlines():
        name, _, path = line.strip().partition(" => ")
        if name.split(" ")[0] == "libjpeg.so.62" and os.path.exists(path):
            return path
    return None


def libjpeg_link() -> dict:
    """The libjpeg (ABI 62, the interface of the headers copied beside
    ``pipeline/csrc/jpegdec.cpp``) that the JPEG decoder links:

    * the system's ``libjpeg.so.62`` where ``ldconfig -p`` lists it, linked
      with ``-ljpeg`` where the unversioned ``libjpeg.so`` beside it names the
      same file, else by its path;
    * else the libjpeg-turbo that Pillow's wheel carries
      (``pillow.libs/libjpeg-*.so.62*``), by its path, with an rpath to it.

    Returns ``{"source", "path", "version", "link_args"}``. Raises
    ``RuntimeError`` when neither exists."""
    path = _ldconfig_libjpeg62()
    if path is not None:
        dev = os.path.join(os.path.dirname(path), "libjpeg.so")
        same = os.path.exists(dev) and os.path.realpath(dev) == os.path.realpath(path)
        return {"source": "system", "path": os.path.realpath(path),
                "version": os.path.basename(os.path.realpath(path)),
                "link_args": ["-ljpeg"] if same else [path]}
    try:
        import PIL
        from PIL import features
    except ImportError:
        libs = []
    else:
        libs_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(PIL.__file__))),
                                "pillow.libs")
        libs = sorted(glob.glob(os.path.join(libs_dir, "libjpeg-*.so.62*")))
    if not libs:
        raise RuntimeError("no libjpeg with the ABI-62 interface: ldconfig -p lists no "
                           "libjpeg.so.62 and Pillow's wheel carries none in pillow.libs/")
    return {"source": "pillow", "path": libs[0],
            "version": f"libjpeg-turbo {features.version('libjpeg_turbo')}",
            "link_args": [libs[0], f"-Wl,-rpath,{os.path.dirname(libs[0])}"]}


def build_cuda_lib(src: str, stem: str, extra_flags: Optional[List[str]] = None) -> str:
    """Compile CUDA ``src`` for sm_90a into ``_build/<stem>-<hash>.so``."""
    return _build([nvcc_path()], src, stem, NVCC_FLAGS + list(extra_flags or []), [])
