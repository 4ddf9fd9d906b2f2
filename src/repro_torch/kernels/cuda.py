"""Build, load and count the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface and loaded with :mod:`ctypes`. Nothing is
built when this module is imported: the first launch of a kernel builds its
library, and :func:`build_all` builds every library at once, one ``nvcc``
process per source, all started together. Libraries land in ``_build/``
beside this file, named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt.
A failed build raises; no caller falls back to the plain PyTorch version.
A development variant of a source (``-D`` macros, ``library(name,
defines)``) is built beside it under its own hash, for measurements only.

``launches[name]`` counts the launches of each kernel. A wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

__all__ = ["KERNELS", "launches", "reset_launches", "build_all", "library", "check"]

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
KERNELS = ("lif_update", "spike_deliver", "superstep_lif", "superstep_iaf",
           "flash_attention", "event_deliver")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
_LIB = ("-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
# Flags per source. The simulator's kernels are bitwise exact only with the
# fused multiply-adds their sources spell out with intrinsics, so nvcc may
# contract no others (-fmad=false; see csrc/lif_update.cu). Attention is
# held to a tolerance, and nvcc may contract its FMAs; it links the driver
# library for the TMA tensor maps (cuTensorMapEncodeTiled).
NVCC_FLAGS = {
    name: _ARCH + _LIB + ("-lcuda",) if name == "flash_attention"
    else _ARCH + ("-fmad=false",) + _LIB
    for name in KERNELS
}

launches: dict[str, int] = {name: 0 for name in KERNELS}
build_logs: dict[str, str] = {}
_libs: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_U32 = ctypes.c_uint32
_SIGNATURES = {
    "lif_update": {
        "lif_update_launch": [_P] * 9 + [_I64] + [_F] * 5 + [_I, _P],
    },
    "spike_deliver": {
        name: [_P, _I64] + [_P] * 5 + [_I64, _I, _I, _I, _I64, _I64, _P]
        for name in ("spike_deliver_i8_launch", "spike_deliver_i32_launch")
    },
    "superstep_lif": {
        "superstep_lif_launch": [_P] * 13 + [_I] + [_P] * 4 + [_I64, _I64]
        + [_I] * 5 + [_I64, _U32] + [_F] * 5 + [_I, _F, _I64, _P],
    },
    "superstep_iaf": {
        "superstep_iaf_launch": [_P] * 8 + [_I] + [_P] * 3 + [_I64, _I64]
        + [_I] * 5 + [_P],
        "superstep_iaf_smem_bytes": [_I64, _I, _I],
        "superstep_iaf_mask_in_smem": [_I64, _I, _I],
    },
    "flash_attention": {
        "flash_attention_launch": [_P] * 4 + [_I] * 9 + [_P],
        "flash_attention_smem_bytes": [_I, _I],
    },
    "event_deliver": {
        **{name: [_P] * 6 + [_I64, _I, _I, _I, _I, _I64, _I64, _I64, _P]
           for name in ("event_deliver_i8_launch", "event_deliver_i32_launch")},
        "event_deliver_slice_rows": [_I, _P],
        "event_deliver_red_probe": [_P, _I64, _I, _I64, _P],
    },
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): nvcc is "
                           "needed to build the repro_torch kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _flags(name: str, defines: tuple[str, ...]) -> list[str]:
    return [*NVCC_FLAGS[name], *(f"-D{x}" for x in defines)]


def _target(name: str, defines: tuple[str, ...] = ()) -> Path:
    parts = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in parts) + " ".join(_flags(name, defines)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=KERNELS, defines: tuple[str, ...] = ()) -> dict[str, float]:
    """Build every library not yet built, in parallel; seconds per source.

    Raises ``RuntimeError`` with the compiler's output if any build fails.
    The ``-Xptxas -v`` report (registers, shared memory, spills) of each
    build is kept in ``build_logs``, under the name and the ``defines``.
    """
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        target = _target(name, defines)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(name, defines), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (time.perf_counter(), tmp, target, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    seconds, failed = {}, []
    for name, (t0, tmp, target, proc) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_logs[" ".join((name, *defines))] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def library(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use; with
    ``defines`` (``"MACRO=value"``), a development variant of its source."""
    lib = _libs.get((name, defines))
    if lib is None:
        build_all((name,), defines)
        lib = ctypes.CDLL(str(_target(name, defines)))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _libs[name, defines] = lib
    return lib


def check(name: str, err: int) -> None:
    """Raise if a launch of kernel ``name`` returned a CUDA error."""
    if err != 0:
        msg = library(name).error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")
