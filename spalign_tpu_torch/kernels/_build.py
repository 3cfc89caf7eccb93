"""Build the package's CUDA sources into shared libraries.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``spalign_tpu_torch/_build/`` at
first use, then loaded with ``ctypes``.  A source without PyTorch's
headers compiles in seconds.  The library's file name carries a hash of
the source, the ``csrc/`` headers it includes (``#include "..."``, and
theirs) and the flags, so an edited source or header is rebuilt.  A
failed build raises: there is no fallback to the plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def local_headers(source: Path) -> list:
    """The ``csrc/`` headers ``source`` includes with quotes, and those
    they include, each once, in the order first reached."""
    found, todo = [], [source]
    while todo:
        for name in _LOCAL_INCLUDE.findall(todo.pop(0).read_text()):
            path = CSRC_DIR / name
            if path not in found:
                found.append(path)
                todo.append(path)
    return found


def find_nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


class CudaLibrary:
    """One CUDA source, built and loaded on first use.

    ``signatures`` maps each exported C function to (restype, argtypes),
    declared on load.  ``build_seconds`` and ``build_log`` (nvcc's
    output, including ``-Xptxas -v``'s registers and shared memory per
    kernel) describe the build this process made or found."""

    def __init__(self, name: str, signatures: dict):
        self.name = name
        self.signatures = signatures
        self.source = CSRC_DIR / f"{name}.cu"
        self.build_seconds = None
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def _build(self) -> Path:
        headers = b"".join(p.read_bytes()
                           for p in local_headers(self.source))
        digest = hashlib.sha256(
            self.source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        out = BUILD_DIR / f"lib{self.name}-{digest}.so"
        log = out.with_suffix(".log")
        if out.exists():
            self.build_seconds = 0.0
            self.build_log = log.read_text() if log.exists() else ""
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        t0 = time.time()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_seconds = time.time() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with code {proc.returncode} building "
                f"{self.source.name}:\n{self.build_log}")
        log.write_text(self.build_log)
        os.replace(tmp, out)
        return out

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self._build()))
                for fn_name, (restype, argtypes) in self.signatures.items():
                    fn = getattr(lib, fn_name)
                    fn.restype, fn.argtypes = restype, argtypes
                self._lib = lib
            return self._lib
