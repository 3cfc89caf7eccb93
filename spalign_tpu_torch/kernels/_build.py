"""Build the package's C++ and CUDA sources into shared libraries.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``spalign_tpu_torch/_build/`` at
first use, then loaded with ``ctypes`` (``CudaLibrary``); a source
without PyTorch's headers compiles in seconds.  ``csrc/<name>.cpp``
holds host code, compiled the same way by ``g++`` with the JAX package's
native flags (``HostLibrary``).  The library's file name carries a hash
of the source, the ``csrc/`` headers it includes (``#include "..."``,
and theirs) and the flags, so an edited source or header is rebuilt.  A
failed build raises with the compiler's output: there is no fallback to
a plain version.
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
# the flags of spalign_tpu/native (same source, same flags: same maps)
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
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


def find_gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: put g++ on PATH")
    return found


class CudaLibrary:
    """One CUDA source, built and loaded on first use.

    ``signatures`` maps each exported C function to (restype, argtypes),
    declared on load.  ``build_seconds`` and ``build_log`` (the
    compiler's output; nvcc's includes ``-Xptxas -v``'s registers and
    shared memory per kernel) describe the build this process made or
    found."""

    suffix, flags = ".cu", NVCC_FLAGS

    @staticmethod
    def compiler() -> str:
        return find_nvcc()

    def target(self) -> bytes:
        """What else decides the built code: nothing for nvcc's fixed
        target."""
        return b""

    def __init__(self, name: str, signatures: dict):
        self.name = name
        self.signatures = signatures
        self.source = CSRC_DIR / f"{name}{self.suffix}"
        self.build_seconds = None
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def _build(self) -> Path:
        headers = b"".join(p.read_bytes()
                           for p in local_headers(self.source))
        digest = hashlib.sha256(
            self.source.read_bytes() + headers + " ".join(self.flags).encode()
            + self.target()).hexdigest()[:16]
        out = BUILD_DIR / f"lib{self.name}-{digest}.so"
        log = out.with_suffix(".log")
        if out.exists():
            self.build_seconds = 0.0
            self.build_log = log.read_text() if log.exists() else ""
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [self.compiler(), *self.flags, "-o", str(tmp), str(self.source)]
        t0 = time.time()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_seconds = time.time() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"{Path(cmd[0]).name} failed with code {proc.returncode} "
                f"building {self.source.name}:\n{self.build_log}")
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


class HostLibrary(CudaLibrary):
    """One C++ source of host code (``csrc/<name>.cpp``), built by g++
    and loaded on first use; the rest as ``CudaLibrary``."""

    suffix, flags = ".cpp", GXX_FLAGS

    @staticmethod
    def compiler() -> str:
        return find_gxx()

    def target(self) -> bytes:
        """The options ``-march=native`` resolves to on this machine, so
        that a library built for another CPU is never loaded here."""
        proc = subprocess.run([self.compiler(), "-march=native", "-Q",
                               "--help=target"], capture_output=True)
        if proc.returncode != 0:
            raise RuntimeError("g++ -march=native -Q --help=target failed:\n"
                               + proc.stderr.decode(errors="replace"))
        return proc.stdout
