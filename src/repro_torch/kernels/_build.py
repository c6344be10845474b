"""Build and load the port's CUDA kernels (one shared library, ctypes).

The sources under ``repro_torch/csrc/`` expose a plain C interface, so each
compiles with ``nvcc`` alone (no PyTorch headers) in seconds.  Every source
compiles to its own object in parallel, and the objects link into one
``.so`` for ``sm_90a`` (Hopper) under ``build/kernels/`` at the repository
root, named by a hash of the sources and flags so a stale build is never
loaded.  The build happens at first use, never at import: the module is
importable where there is no ``nvcc`` (the CPU tests import every module).

    lib = load()          # builds once per process, then returns the handle
    print(build_log())    # what ``nvcc -Xptxas -v`` reported for each kernel
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("rmsnorm.cu", "flash_attention.cu", "grouped_gemm.cu", "ssd_scan.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: Optional[ctypes.CDLL] = None
_log: str = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(out_path: Path) -> str:
    """Compile every source in parallel, then link one shared library.
    Returns the compilers' combined output (``-Xptxas -v`` reports)."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        logs, objs, failed = [], [], []
        for name, obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {name}\n{out}")
            objs.append(str(obj))
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(logs)
            )
        tmp_lib = Path(tmp) / out_path.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, out_path)
    return "\n".join(logs)


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first call in this process."""
    global _lib, _log
    if _lib is not None:
        return _lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    log_path = so.with_suffix(".log")
    if so.exists() and log_path.exists():
        _log = log_path.read_text()
    else:
        _log = _compile(so)
        log_path.write_text(_log)
    lib = ctypes.CDLL(str(so))
    lib.rmsnorm_fwd.argtypes = [
        _P, _P, _P, _I, _I, _I, _F,        # x, w, out, rows, d, dtype, eps
        _I, _I, _I, _I,                    # lanes (0: generic kernel), packs, groups, grid
        _P,                                # stream
    ]
    lib.rmsnorm_fwd.restype = _I
    lib.flash_attention_fwd.argtypes = [
        _P, _P, _P, _P,                    # q, k, v, out
        _P, _LL,                           # decode workspace (or null), its fp32 count
        _P, _P,                            # q_offsets, q_lens
        _I, _I, _I, _I, _I, _I, _I,        # B, Sq, H, Sk, KV, D, dtype
        _F, _I, _I, _F, _I,                # scale, causal, window, softcap, k_len
        _P,                                # stream
    ]
    lib.flash_attention_fwd.restype = _I
    lib.flash_attention_paged_fwd.argtypes = [
        _P, _P, _P, _P, _P,                # q, pool_k, pool_v, table, out
        _P, _LL,                           # decode workspace (or null), its fp32 count
        _P, _P,                            # q_offsets, q_lens
        _I, _I, _I, _I, _I,                # B, Sq, H, KV, D
        _I, _I, _I, _I,                    # P, pages_per_slot, num_pages_plus_1, dtype
        _F, _I, _I, _F,                    # scale, causal, window, softcap
        _P,                                # stream
    ]
    lib.flash_attention_paged_fwd.restype = _I
    lib.grouped_gemm_fwd.argtypes = [
        _P, _P, _P, _P,                    # x, w, group_sizes, out
        _P, _P,                            # split-K workspace, arrival counters (or null)
        _I, _I, _I, _I, _I,                # M, K, N, E, dtype
        _I, _I,                            # K splits, SMs
        _P,                                # stream
    ]
    lib.grouped_gemm_fwd.restype = _I
    lib.ssd_scan_fwd.argtypes = [
        _P, _P, _P, _P, _P, _P,            # x, dt, A, B, C, init_state (or null)
        _P, _P,                            # y, final_state
        _I, _I, _I, _I, _I, _I, _I, _I,    # B, S, H, P, G, N, chunk, dtype
        _P, _P,                            # stream, int* kernel that ran (1 tensor-core)
    ]
    lib.ssd_scan_fwd.restype = _I
    _lib = lib
    return lib


def build_log() -> str:
    """What ``nvcc -Xptxas -v`` printed when the library was built
    (registers, shared memory and spills per kernel); empty before
    :func:`load`."""
    return _log


def refuse_fakes(what: str, *tensors) -> None:
    """Raise if any of ``tensors`` is a fake tensor (no storage: a dry-run's
    stand-in): a kernel must never be handed its pointers."""
    from torch._subclasses.fake_tensor import FakeTensor

    if any(isinstance(t, FakeTensor) for t in tensors):
        raise RuntimeError(f"{what}: a fake tensor reached the CUDA kernel (the dry-run "
                           "counts the plain paths)")


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
