"""Build the CUDA kernels under ``ssip_tpu_torch/csrc/`` at first use.

Route: ``nvcc`` compiles every ``csrc/*.cu`` (which may include the
``csrc/*.cuh`` headers) for ``sm_90a`` — one process per source, all
started together — and links the objects into one shared
library with a plain C interface, loaded with ``ctypes``. No
``torch/extension.h``, so a build takes seconds rather than the minutes a
PyTorch extension build takes. (The idea of ``ssip_tpu/native/build.py``,
which builds the JPEG decoder the same way, not its code.)

The library lands in ``build/ssip_tpu_torch/`` at the repository root
(listed in ``.gitignore``), named by a hash of the sources, headers and
flags, so an edited source or header rebuilds and an unchanged set loads
the existing file. nvcc's report (``ptxas -v``: registers, shared memory and spills per kernel) is
kept beside it, so a reused library still has one.
Nothing here runs at import time: a machine without ``nvcc`` imports the
package and uses the plain PyTorch versions for CPU tensors.

    python -m ssip_tpu_torch.kernels.build   # build now, print nvcc's report
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
)


@dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # 0.0 when an existing library was reused
    log: str  # nvcc's stdout + stderr (ptxas -v report), read back when reused


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


def headers() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    """Of the flags, the sources and the headers they include: an edited
    header rebuilds too."""
    hasher = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        hasher.update(src.name.encode())
        hasher.update(src.read_bytes())
    return hasher.hexdigest()[:16]


def build() -> BuildResult:
    """Compile ``csrc/*.cu`` unless the library for these sources exists."""
    target = BUILD_DIR / f"libssip_kernels_{source_hash()}.so"
    report = target.with_suffix(".log")
    if target.is_file():
        return BuildResult(target, 0.0, report.read_text() if report.is_file() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{source_hash()}.{os.getpid()}"
    objects = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    log = ""
    procs = []
    try:
        for src, obj in zip(sources(), objects):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        for cmd, proc in procs:
            out, _ = proc.communicate()
            log += out
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp), *map(str, objects)]
        proc = subprocess.run(link, capture_output=True, text=True, check=False)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n{log}")
        report.write_text(log)
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    finally:
        for _, proc in procs:  # after a failure, stop the compiles still running
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        tmp.unlink(missing_ok=True)
        for obj in objects:
            obj.unlink(missing_ok=True)
    return BuildResult(target, time.perf_counter() - t0, log)


def kernel_resources(log: str) -> dict:
    """Per kernel (mangled name) what ``ptxas -v`` reported in ``log``:
    ``registers``, static shared memory ``smem_bytes``, ``stack_bytes``,
    ``spill_stores`` and ``spill_loads`` (bytes)."""
    found: dict = {}
    name = None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            name = entry.group(1)
            found[name] = {"registers": 0, "smem_bytes": 0, "stack_bytes": 0, "spill_stores": 0, "spill_loads": 0}
            continue
        if name is None:
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if frame:
            found[name].update(stack_bytes=int(frame[1]), spill_stores=int(frame[2]), spill_loads=int(frame[3]))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            found[name]["registers"] = int(used[1])
            smem = re.search(r"(\d+) bytes smem", line)
            found[name]["smem_bytes"] = int(smem[1]) if smem else 0
    return found


@lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build if needed, then load; callers declare each function's argtypes."""
    return ctypes.CDLL(str(build().path))


if __name__ == "__main__":
    result = build()
    print(result.log, end="")
    print(f"{result.path} ({result.seconds:.1f} s)")
