"""Builds the port's CUDA sources at first use and binds them with ctypes.

Each ``ops/csrc/<name>.cu`` has a plain C interface (no PyTorch headers) and
compiles on its own into ``co_zkvms_tpu_torch/build/lib<name>.so`` with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/lib<name>.so ops/csrc/<name>.cu

which takes seconds. ``build_all`` starts one nvcc per source, all
together, and returns each build's ``-Xptxas -v`` report.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``KernelFn`` raises on a non-zero code and counts the launches it made.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import torch

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "ops", "csrc")
BUILD_DIR = os.path.join(PKG, "build")
SOURCES = ("field_kernels", "g1", "msm_bucket", "sumcheck_round", "poseidon")
ARCH = "arch=compute_90a,code=sm_90a"


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; raises when a card is asked for and
    there is none (the port never falls back to the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device`` as an int for ctypes."""
    return torch.cuda.current_stream(device).cuda_stream


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    out = _lib_path(name)
    if not os.path.exists(out):
        return True
    newest = max(os.path.getmtime(os.path.join(CSRC, f))
                 for f in os.listdir(CSRC))
    return os.path.getmtime(out) < newest


def _command(name: str, tmp_out: str) -> list:
    return [_nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp_out,
            os.path.join(CSRC, f"{name}.cu")]


def build_all(names=SOURCES) -> dict:
    """Compile the given sources in parallel (one nvcc each).

    Returns {name: nvcc's output, with the -Xptxas -v report}; raises with
    that output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        tmp = _lib_path(name) + f".{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp)
    report = {}
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        report[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name} (rc {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return report


def ptxas_summary(log: str) -> list:
    """One 'kernel: registers, spill stores' line per entry function of an
    ``-Xptxas -v`` log."""
    lines = []
    current = spill = props = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1]
        elif "Function properties for" in line:
            # also printed for non-entry (noinline) device functions
            props = line.split("Function properties for")[1].strip()
        elif "spill stores" in line and current and props == current:
            spill = line.split(",")[1].strip()
        elif "Used" in line and "registers" in line and current:
            regs = line.split("Used")[1].split(",")[0].strip()
            lines.append(f"{current}: {regs}, {spill or 'spill stores not reported'}")
            current = spill = None
    return lines


_LIBS: dict = {}


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``ops/csrc/<name>.cu``, built if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            build_all((name,))
        lib = ctypes.CDLL(_lib_path(name))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


# every KernelFn, by name: chip_smoke.py zeroes and reads their counters
KERNELS: dict = {}


class KernelFn:
    """One C entry point of a kernel library, with its launch counter.

    ``launches`` grows by one for each launch this object makes, and
    nowhere else; ``replaces`` names the TPU kernel it stands for."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list,
                 replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces
        self.launches = 0
        self._fn = None
        KERNELS[name] = self

    def __call__(self, *args):
        if self._fn is None:
            lib = load(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = load(self.source).cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err}: {msg}")
        self.launches += 1
