"""Builds a C++ source of ``native/`` into a shared library at first use.

The JAX package builds ``native/`` in place with ``make``; the port builds
the same sources with ``native/Makefile``'s flags into
``clsurvey_torch/_build/`` and never writes into ``native/``. A library's
file name carries a hash of its source and flags, so an edited source
builds anew, and a build writes a temporary file that it moves into place
whole, so that processes building at once see all of it or none.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(REPO, "native")
BUILD_DIR = os.path.join(REPO, "clsurvey_torch", "_build")
# native/Makefile's CXXFLAGS
MAKEFILE_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall")


def library_path(source: str, flags: tuple, stem: str) -> str:
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def _build(source: str, flags: tuple, out: str) -> None:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(out), suffix=".so.tmp")
    os.close(fd)
    cmd = [os.environ.get("CXX", "g++"), *flags, "-o", tmp, source]
    try:
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(
                f"building {source} failed: `{' '.join(cmd)}` exited "
                f"{done.returncode}\n{done.stderr}{done.stdout}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(source: str, flags: tuple, stem: str) -> ctypes.CDLL:
    """The library built from ``source`` with ``$CXX`` (default ``g++``)
    and ``flags``, built first if it is not there. Raises a
    ``RuntimeError`` that holds the compiler's command and output where
    the build fails or there is no compiler."""
    out = library_path(source, flags, stem)
    try:
        if not os.path.isfile(out):
            _build(source, flags, out)
        return ctypes.CDLL(out)
    except OSError as e:
        raise RuntimeError(f"building or loading {source} failed: "
                           f"{e}") from e
