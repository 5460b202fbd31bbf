"""Build the native JPEG decoder at first use.

Counterpart of ``ssip_tpu/native/build.py``: ``g++ -O3 -shared -fPIC
-std=c++17 decode.cpp -ljpeg`` (``:28-31`` there). The library lands in
``build/ssip_tpu_torch/native/`` at the repository root (listed in
``.gitignore``), named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads the existing file; the JAX
package's ``ssip_tpu/native/libssipdecode.so`` is never loaded.

There is no fallback: the paths that need the library (``--host-preproc``,
``--fast-decode``) raise ``NativeBuildError``, naming the missing compiler
or header, where it cannot be built.

    python -m ssip_tpu_torch.native.build   # build now, print the command
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent
SOURCE = NATIVE_DIR / "decode.cpp"
BUILD_DIR = NATIVE_DIR.parents[1] / "build" / "ssip_tpu_torch" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
JPEG_HEADER = Path("/usr/include/jpeglib.h")

_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    """The native decoder cannot be built on this machine."""


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libssipdecode_{digest}.so"


def build(verbose: bool = False) -> Path:
    """The library's path, compiling it first if this source has none yet."""
    target = library_path()
    with _lock:
        if target.exists():
            return target
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise NativeBuildError(
                "the native JPEG decoder needs a C++ compiler (g++, or $CXX) and none was found on PATH; "
                "--host-preproc and --fast-decode cannot run without it"
            )
        if not JPEG_HEADER.exists():
            raise NativeBuildError(
                f"the native JPEG decoder needs libjpeg's header {JPEG_HEADER} (libjpeg-dev), which is missing; "
                "--host-preproc and --fast-decode cannot run without it"
            )
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-ljpeg", "-o", str(tmp)]
        if verbose:
            print("+", " ".join(cmd))
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise NativeBuildError(f"building the native JPEG decoder failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, target)
    return target


if __name__ == "__main__":
    print(build(verbose=True))
