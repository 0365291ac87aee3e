"""Build the port's host C++ libraries with g++ and open them with ctypes.

Each ``native/<name>.cc`` has a plain C interface and compiles on its own
into ``_build/libaptpu_torch_<name>-<hash>.so`` inside the package (the
directory git ignores, beside the CUDA kernels' libraries), at first use,
with the JAX package's ``native/Makefile`` flags.  The file name carries a
hash of the source, the flags, the compiler's path and the host CPU (the
flags say ``-march=native``), so an edited source, another compiler or
another machine's copy of the tree rebuilds; the name differs from the JAX
package's ``libaptpu_*.so``, whose libraries export the same ``aptpu_*``
symbols, and each library is opened with ``RTLD_LOCAL`` so that one
process can hold both.  A build writes a file of its own and renames it
into place, so processes that build at once never see half a library.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC = Path(__file__).resolve().parent
BUILD_DIR = SRC.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")
# the system codec libraries the media module links
MEDIA_LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswresample")
BUILD_TIMEOUT_S = 120


def cxx() -> str | None:
    """Path of the C++ compiler: $CXX, else g++ on PATH; None if neither."""
    name = os.environ.get("CXX") or "g++"
    return shutil.which(name)


def _host_cpu() -> str:
    """The CPU's model name and feature flags, which ``-march=native``
    compiles for."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
    except OSError:
        return ""
    return "".join(sorted(set(lines)))


def library_path(name: str, libs: tuple[str, ...] = ()) -> Path:
    exe = cxx() or ""
    h = hashlib.sha256(" ".join((exe, _host_cpu(), *CXX_FLAGS, *libs)).encode())
    h.update((SRC / f"{name}.cc").read_bytes())
    return BUILD_DIR / f"libaptpu_torch_{name}-{h.hexdigest()[:16]}.so"


def build(name: str, libs: tuple[str, ...] = ()) -> Path:
    """Compile ``native/<name>.cc`` unless an up-to-date library exists;
    return its path.  Raises RuntimeError with the compiler's message."""
    out = library_path(name, libs)
    if out.exists():
        return out
    exe = cxx()
    if exe is None:
        raise RuntimeError("no C++ compiler (set CXX or put g++ on PATH)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [exe, *CXX_FLAGS, "-o", str(tmp), str(SRC / f"{name}.cc"), *libs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as exc:
        raise RuntimeError(f"{name}.cc: the compiler ran past {BUILD_TIMEOUT_S} s") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def load(name: str, libs: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build ``native/<name>.cc`` if needed and open it (RTLD_LOCAL)."""
    return ctypes.CDLL(str(build(name, libs)), mode=os.RTLD_LOCAL)


def include_dirs() -> list[str]:
    """The compiler's own search list for ``#include <...>``."""
    exe = cxx()
    if exe is None:
        return []
    proc = subprocess.run([exe, "-E", "-Wp,-v", "-xc++", os.devnull],
                          capture_output=True, text=True, timeout=60)
    lines = proc.stderr.splitlines()
    try:
        start = lines.index("#include <...> search starts here:") + 1
        end = lines.index("End of search list.")
    except ValueError:
        return []
    return [ln.strip() for ln in lines[start:end]]
