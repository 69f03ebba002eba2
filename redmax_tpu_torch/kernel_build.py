"""Build a CUDA source of csrc/ with nvcc into _build/ and load it.

Each kernel is one .cu file with a plain C interface (no PyTorch headers),
compiled for sm_90a into a shared library keyed by a hash of its sources
and flags, and loaded with ctypes. start() spawns nvcc without waiting, so
several kernels can compile side by side; load() waits for it.
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


class KernelBuild:
    """One kernel library: sources[0] is the .cu file, the rest its headers."""

    def __init__(self, name: str, sources: Sequence[str]):
        self.name = name
        self.sources = tuple(sources)
        self.lib = None
        self.ptxas_report = None  # nvcc -Xptxas -v output of the loaded build
        self._proc = None
        self._so = None

    def _paths(self):
        if self._so is None:
            h = hashlib.sha256()
            for name in self.sources:
                with open(os.path.join(CSRC, name), "rb") as f:
                    h.update(f.read())
            h.update(" ".join(NVCC_FLAGS).encode())
            self._so = os.path.join(BUILD, f"{self.name}_{h.hexdigest()[:16]}.so")
        return self._so, self._so[:-3] + ".ptxas.txt", f"{self._so}.{os.getpid()}.tmp"

    def start(self) -> None:
        """Spawn nvcc unless the library is built or already compiling.
        Raises when nvcc is missing."""
        so, _, tmp = self._paths()
        if self.lib is not None or self._proc is not None or os.path.exists(so):
            return
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError(f"nvcc not found: the {self.name} kernel cannot be built")
        os.makedirs(BUILD, exist_ok=True)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, self.sources[0])]
        self._proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True)

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if need be. Raises when the build
        fails."""
        if self.lib is not None:
            return self.lib
        self.start()
        so, log, tmp = self._paths()
        if self._proc is not None:
            _, err = self._proc.communicate()
            rc, self._proc = self._proc.returncode, None
            if rc != 0:
                raise RuntimeError(f"nvcc failed on {self.sources[0]} ({rc}):\n{err}")
            with open(log, "w") as f:
                f.write(err)
            os.replace(tmp, so)
        with open(log) as f:
            self.ptxas_report = f.read()
        self.lib = ctypes.CDLL(so)
        return self.lib
