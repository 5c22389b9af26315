"""Monorepo build helpers of the port (a copy of ``accvlab_tpu.build_config``,
the equivalent of the reference's ``build_config/accvlab_build_config/helpers``;
it drives the port's own ``g++`` builds, ``accvlab_tpu_torch._native_build``).

The reference centralizes native-extension build policy: CUDA-arch probing
with PTX fallback (``build_utils.py:119``), a per-package external cmake
driver (``run_external_build``, ``build_utils.py:387``), env-var-driven
cmake args + ``.nav``-marker repo-root discovery + setuptools-scm version
forwarding (``cmake_args.py:195,14-40,176``). The helpers cover the host
C++ (the port's CUDA builds keep their fixed ``nvcc`` flags for sm_90a):

* :func:`select_cxx_flags` — toolchain probing (the arch-selection analog):
  which optimization/ISA flags this ``g++`` actually supports, with env
  overrides.
* :func:`run_external_build` — drives a package's ``csrc`` build: cmake +
  ninja/make when a ``CMakeLists.txt`` exists, direct ``g++`` otherwise;
  content-hash-keyed outputs (never stale).
* :func:`build_cmake_args` — env-var-driven cmake arguments with version
  forwarding.
* :func:`find_repo_root` — marker-based repo-root discovery.
* :func:`get_package_version` — version forwarding from installed metadata
  or ``pyproject.toml``.
"""

from .helpers import (
    build_cmake_args,
    find_repo_root,
    get_package_version,
    probe_cxx_flag,
    run_external_build,
    select_cxx_flags,
)

__all__ = [
    "build_cmake_args",
    "find_repo_root",
    "get_package_version",
    "probe_cxx_flag",
    "run_external_build",
    "select_cxx_flags",
]
