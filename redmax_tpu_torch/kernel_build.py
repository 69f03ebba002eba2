"""Build a CUDA source of csrc/ with nvcc into _build/ and load it.

Each kernel is one .cu file with a plain C interface (no PyTorch headers),
compiled for sm_90a into a shared library keyed by a hash of its sources
and flags, and loaded with ctypes. start() spawns nvcc without waiting, so
several kernels can compile side by side; load() waits for it. nvcc writes
its messages to a file beside the library, not to a pipe: a pipe that no one
reads until nvcc exits would stop nvcc once it filled.

A host build (host=True) compiles a C++ source of csrc/ with g++ the same
way, for a kernel whose lane body also runs on CPU tensors (pgs_kernel).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Sequence

_ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_ROOT, "csrc")
BUILD = os.path.join(_ROOT, "_build")
# No --use_fast_math: the QP boxes hold infinities and NaN marks a diverged lane.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


class KernelBuild:
    """One kernel library: sources[0] is the .cu file (a .cpp file for a
    host build), the rest its headers; defines are extra compiler flags
    (-D...) of this build; host: g++ for the CPU instead of nvcc."""

    def __init__(self, name: str, sources: Sequence[str], defines: Sequence[str] = (),
                 host: bool = False):
        self.name = name
        self.sources = tuple(sources)
        self.defines = tuple(defines)
        self.host = host
        self.flags = (HOST_FLAGS if host else NVCC_FLAGS) + self.defines
        self.lib = None
        self.ptxas_report = None  # nvcc -Xptxas -v output of the loaded build (g++'s, host)
        self._proc = None
        self._so = None

    def _paths(self):
        if self._so is None:
            h = hashlib.sha256()
            for name in self.sources:
                with open(os.path.join(CSRC, name), "rb") as f:
                    h.update(f.read())
            h.update(" ".join(self.flags).encode())
            self._so = os.path.join(BUILD, f"{self.name}_{h.hexdigest()[:16]}.so")
        return self._so, self._so[:-3] + ".ptxas.txt", f"{self._so}.{os.getpid()}.tmp"

    def _messages(self) -> str:
        """The compiler's messages of the build in flight (its log beside the
        library)."""
        return f"{self._paths()[2]}.log"

    def _compiler(self) -> str:
        """g++ for a host build, else nvcc. Raises when it is missing."""
        if self.host:
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError(f"g++ not found: the host build of {self.name} cannot be built")
            return gxx
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError(f"nvcc not found: the {self.name} kernel cannot be built")
        return nvcc

    def start(self) -> None:
        """Spawn the compiler unless the library is built or already
        compiling. Raises when the compiler is missing."""
        so, _, tmp = self._paths()
        if self.lib is not None or self._proc is not None or os.path.exists(so):
            return
        cc = self._compiler()
        os.makedirs(BUILD, exist_ok=True)
        cmd = [cc, *self.flags, "-o", tmp, os.path.join(CSRC, self.sources[0])]
        with open(self._messages(), "w") as out:
            self._proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT)

    def compiling(self) -> bool:
        """True while a started nvcc has not exited."""
        return self._proc is not None and self._proc.poll() is None

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if need be. Raises when the build
        fails."""
        if self.lib is not None:
            return self.lib
        self.start()
        so, log, tmp = self._paths()
        if self._proc is not None:
            rc, self._proc = self._proc.wait(), None
            with open(self._messages()) as f:
                err = f.read()
            os.remove(self._messages())
            if rc != 0:
                cc = "g++" if self.host else "nvcc"
                raise RuntimeError(f"{cc} failed on {self.name} ({self.sources[0]} "
                                   f"{' '.join(self.defines)}; exit {rc}):\n{err}")
            with open(log, "w") as f:
                f.write(err)
            os.replace(tmp, so)
        with open(log) as f:
            self.ptxas_report = f.read()
        self.lib = ctypes.CDLL(so)
        return self.lib
