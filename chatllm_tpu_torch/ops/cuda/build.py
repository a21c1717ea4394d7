"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source becomes one plain-C-ABI shared library, compiled by nvcc for
sm_90a into `chatllm_tpu_torch/_build/` (listed in .gitignore) at first use
on a CUDA tensor, and loaded with ctypes.  The library name carries a hash of
the sources, so an edited kernel is rebuilt and a stale one is never loaded.
`build_all()` starts one nvcc per source, all at once.  A source may export
several launchers (csrc/gemv_probe.cu does); each is its own `CudaKernel`
with its own count, and the library is built once.

Each kernel object keeps `launches`, a plain count of the launches its
wrapper made; callers reset and read it to show that a path ran the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


class CudaKernel:
    """One csrc/*.cu library: its exported launcher and a launch count."""

    def __init__(self, source: str, fn: str, argtypes: list, name: str | None = None):
        self.source = source
        self.fn = fn
        self.argtypes = argtypes
        self.name = name or Path(source).stem
        self.launches = 0
        self._call = None
        self._lib = None

    def lib_path(self) -> Path:
        h = hashlib.sha256()
        for p in sorted(CSRC.glob("*.cuh")) + [CSRC / self.source]:
            h.update(p.name.encode())
            h.update(p.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{Path(self.source).stem}-{h.hexdigest()[:12]}.so"

    def start_build(self):
        """Start nvcc unless the library exists; returns the process or None."""
        out = self.lib_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc.cl_tmp, proc.cl_out, proc.cl_cmd = tmp, out, cmd
        return proc

    @staticmethod
    def finish_build(proc):
        log, _ = proc.communicate()
        proc.cl_out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(proc.cl_cmd)}\n{log}")
        os.replace(proc.cl_tmp, proc.cl_out)

    def _load(self):
        if self._call is None:
            proc = self.start_build()
            if proc is not None:
                self.finish_build(proc)
            lib = ctypes.CDLL(str(self.lib_path()))
            fn = getattr(lib, self.fn)
            fn.argtypes = self.argtypes
            fn.restype = I
            lib.cl_error_string.argtypes = [I]
            lib.cl_error_string.restype = ctypes.c_char_p
            self._lib, self._call = lib, fn
        return self._call

    def launch(self, *args):
        """Call the launcher on the current stream's arguments; raises on a
        refused launch.  Counts one launch."""
        rc = self._load()(*args)
        if rc != 0:
            msg = self._lib.cl_error_string(rc).decode()
            raise RuntimeError(f"{self.fn}: CUDA error {rc} ({msg})")
        self.launches += 1


QGEMV = CudaKernel("qgemv.cu", "qgemv_launch",
                   [P, I, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P])
QMM = CudaKernel("qmm.cu", "qmm_launch",
                 [P, I, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, P])
FLASH = CudaKernel("flash_attention.cu", "flash_attention_launch",
                   [P, P, P, P, P, I, I, I, I, I, I, I, I, F, I, I, F, I, P])

FLASH_DECODE = CudaKernel("flash_decode.cu", "flash_decode_launch",
                          [P, P, P, P, P, P, P, I, P, P, P, P,
                           I, I, I, I, I, I, I, F, I, F, I, I, I, I, P])
FLASH_DECODE_INT8 = CudaKernel("flash_decode.cu", "flash_decode_int8_launch",
                               [P, P, P, P, P, P, P, I, P, P, P, P,
                                I, I, I, I, I, I, I, F, I, F, I, I, P], name="flash_decode_int8")
QMM_DECODE = CudaKernel("qmm_decode.cu", "qmm_decode_launch",
                        [P, P, I, I, I, I, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P])
BW_PROBE = CudaKernel("bw_probe.cu", "bw_probe_launch", [P, L, P, P, P, I, I, P])
GEMV_STREAM = CudaKernel("gemv_probe.cu", "gemv_stream_launch", [P, P, I, I, I, P],
                         name="gemv_stream")
GEMV_VPU = CudaKernel("gemv_probe.cu", "gemv_vpu_launch", [P, P, P, P, P, I, I, I, P],
                      name="gemv_vpu")
STREAM_READ = CudaKernel("gemv_model.cu", "stream_read_launch", [P, P, P, P, P, I, I, I, I, P],
                         name="stream_read")
QGEMV_BF16 = CudaKernel("gemv_model.cu", "qgemv_bf16_launch", [P, P, P, P, P, I, I, I, P],
                        name="qgemv_bf16")
UNPACK_GEMV = CudaKernel("gemv_unpack.cu", "unpack_gemv_launch",
                         [P, P, P, P, P, P, P, P, I, I, I, I, P], name="unpack_gemv")
QMM_DMA = CudaKernel("qmm_dma.cu", "qmm_dma_launch", [P, P, P, P, I, I, I, I, P],
                     name="qmm_dma")
QMM_UNPACK = CudaKernel("qmm_unpack.cu", "qmm_unpack_launch",
                        [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P], name="qmm_unpack")
QMM_UNPACK_DIAG = CudaKernel("qmm_unpack.cu", "qmm_unpack_diag_launch",
                             [P, P, P, P, P, P, P, P, I, I, I, I, I, P], name="qmm_unpack_diag")

KERNELS = {k.name: k for k in (QGEMV, QMM, FLASH, FLASH_DECODE, FLASH_DECODE_INT8, QMM_DECODE,
                               BW_PROBE, GEMV_STREAM, GEMV_VPU, STREAM_READ, QGEMV_BF16,
                               UNPACK_GEMV, QMM_DMA, QMM_UNPACK, QMM_UNPACK_DIAG)}


def build_all() -> dict:
    """Compile every kernel library that is missing, one nvcc per source,
    all started together.  Returns the build logs by kernel name."""
    procs = {}
    for k in KERNELS.values():
        if k.lib_path() not in procs:
            procs[k.lib_path()] = k.start_build()
    for p in procs.values():
        if p is not None:
            CudaKernel.finish_build(p)
    logs = {}
    for name, k in KERNELS.items():
        log = k.lib_path().with_suffix(".log")
        logs[name] = log.read_text() if log.exists() else ""
    return logs


def reset_launch_counts():
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
