"""Build the port's CUDA sources at first use and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
alone into `build/kernels/<name>-<digest>.so` at the repository root (a
directory `.gitignore` lists), where the digest covers the source, every
header it includes from `csrc/` and the flags: an unchanged kernel is built
once, an edited one (or one whose header was edited) anew. Sources
include only the CUDA runtime's headers, never PyTorch's, so a build
takes seconds. `build` starts one `nvcc` per source, all at once.

Nothing is built or loaded when this module is imported: the CPU tests
import every module, and this host has no `nvcc`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


@dataclasses.dataclass(frozen=True)
class Built:
    name: str
    path: Path
    seconds: float  # 0.0 when an earlier build was reused
    log: str  # nvcc's output (ptxas registers / shared memory / spills)


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc,
    or the first `nvcc` on PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built on a machine with "
            "the CUDA toolkit (set CUDA_HOME)"
        )
    return found


def sources(name: str) -> list[Path]:
    """`csrc/<name>.cu`, then every header it includes with quotes,
    recursively, each once, in the order first reached."""
    found = [CSRC / f"{name}.cu"]
    for path in found:
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = path.parent / inc.decode()
            if dep not in found:
                found.append(dep)
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: tuple[str, ...]) -> list[Built]:
    """Compile every source in `names` not built yet, one `nvcc` each, all
    started together; raise with the compiler's output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = []
    done = []
    for name in names:
        target = _target(name)
        if target.is_file():
            done.append(Built(name, target, 0.0, ""))
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        todo.append((name, target, tmp, proc, time.perf_counter()))
    failed = []
    for name, target, tmp, proc, t0 in todo:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)  # atomic: concurrent builders both succeed
        done.append(Built(name, target, seconds, log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        (built,) = build((name,))
        lib = _LOADED[name] = ctypes.CDLL(str(built.path))
    return lib
