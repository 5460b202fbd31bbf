"""Build the CUDA kernels under ``ssip_tpu_torch/csrc/`` at first use.

Route: ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes`` — no
``torch/extension.h``, so a build takes seconds rather than the minutes a
PyTorch extension build takes. (The idea of ``ssip_tpu/native/build.py``,
which builds the JPEG decoder the same way, not its code.)

The library lands in ``build/ssip_tpu_torch/`` at the repository root
(listed in ``.gitignore``), named by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads the existing file.
Nothing here runs at import time: a machine without ``nvcc`` imports the
package and uses the plain PyTorch versions for CPU tensors.

    python -m ssip_tpu_torch.kernels.build   # build now, print nvcc's report
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "ssip_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
)


@dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # 0.0 when an existing library was reused
    log: str  # nvcc's stdout + stderr (ptxas -v report); "" when reused


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, /usr/local/cuda "
            "and PATH): the CUDA kernels cannot be built on this machine"
        )
    return found


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    hasher = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        hasher.update(src.name.encode())
        hasher.update(src.read_bytes())
    return hasher.hexdigest()[:16]


def build() -> BuildResult:
    """Compile ``csrc/*.cu`` unless the library for these sources exists."""
    target = BUILD_DIR / f"libssip_kernels_{source_hash()}.so"
    if target.is_file():
        return BuildResult(target, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    return BuildResult(target, seconds, log)


@lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build if needed, then load; callers declare each function's argtypes."""
    return ctypes.CDLL(str(build().path))


if __name__ == "__main__":
    result = build()
    print(result.log, end="")
    print(f"{result.path} ({result.seconds:.1f} s)")
