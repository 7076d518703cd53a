"""Build the CUDA sources in ``csrc/`` at first use and bind them with ctypes.

Each ``*.cu`` is compiled by its own ``nvcc`` process for ``sm_90a`` (all
started together), the objects are linked into one shared library with a
plain C interface, and the library is loaded with ``ctypes``. The output
goes to ``src/repro_torch/_build/<hash of sources and flags>/``, so an
edited source builds anew and an unchanged one loads in milliseconds. No
PyTorch header is compiled, which keeps a build to seconds.

A missing ``nvcc`` or a failed build raises; nothing falls back. Every
exported function returns the ``cudaError_t`` of ``cudaGetLastError()``
right after its launch, and ``check`` raises on a non-zero value.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_ROOT = PACKAGE / "_build"
LIB_NAME = "libilpm_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argtypes of every exported entry point: dtype code, pointers, ints, stream
SIGNATURES = {
    "ilpm_conv_launch": [_I] + [_P] * 5 + [_I] * 15 + [_P] * 2,
    "pointwise_conv_launch": [_I] + [_P] * 5 + [_I] * 9 + [_P] * 2,
    "fused_residual_conv_launch": [_I] + [_P] * 6 + [_I] * 12
    + [_P] * 2,
    "depthwise_conv_launch": [_I] + [_P] * 5 + [_I] * 14 + [_P],
    "fused_inverted_residual_launch": [_I] + [_P] * 11 + [_I] * 13
    + [_P] * 2,
    "direct_conv_launch": [_I] + [_P] * 5 + [_I] * 13 + [_P] * 2,
    "libdnn_conv_launch": [_I] + [_P] * 5 + [_I] * 12 + [_P] * 2,
    "im2col_unroll_launch": [_I] + [_P] * 2 + [_I] * 10 + [_P],
    "gemm_launch": [_I] * 2 + [_P] * 3 + [_I] * 7 + [_P] * 2,
    "winograd_input_transform_launch": [_I] + [_P] * 2 + [_I] * 4 + [_P],
    "winograd_output_transform_launch": [_I] + [_P] * 4 + [_I] * 8 + [_P],
    "causal_conv1d_launch": [_I] + [_P] * 4 + [_I] * 4 + [_L] * 2
    + [_I] * 3 + [_P],
    "causal_conv1d_bwd_launch": [_I] + [_P] * 7 + [_I] * 4 + [_L] * 4
    + [_I] * 3 + [_P],
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ACT_CODES = {None: 0, "relu": 1, "relu6": 2}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME/bin): the "
        "port's CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> tuple[Path, float]:
    """Compile and link the library unless this source hash is built.
    Returns (library path, seconds spent building)."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0
    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [compiler, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        (out_dir / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [compiler, "-shared", "-o", str(tmp_lib),
             *(str(obj) for _, obj, _ in procs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {LIB_NAME} failed:\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(tmp_lib, lib)  # atomic: a reader sees no half-written file
    return lib, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: launch failed with cudaError_t {err}")


def stream(device) -> int:
    """PyTorch's current stream on ``device``, as a pointer-sized int."""
    return torch.cuda.current_stream(device).cuda_stream


def check_operand(kernel, name, t, device, dtype, shape=None):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``
    (of ``shape`` when given)."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{kernel}: {name} is {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} is not contiguous")


def kernel_dtype(kernel, t) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise ValueError(f"{kernel}: unsupported dtype {t.dtype}; kernels "
                         f"take {list(DTYPE_CODES)}") from None


def act_code(act) -> int:
    try:
        return ACT_CODES[act]
    except KeyError:
        raise ValueError(f"unknown activation {act!r}") from None


def epilogue_vectors(scale, bias, k, device):
    """The (K,) fp32 scale and bias a kernel reads: ones for a missing
    scale, zeros for a missing bias."""
    sc = torch.ones(k, dtype=torch.float32, device=device) if scale is None \
        else scale.float().contiguous()
    bi = torch.zeros(k, dtype=torch.float32, device=device) if bias is None \
        else bias.float().contiguous()
    for name, v in (("scale", sc), ("bias", bi)):
        check_operand("epilogue", name, v, device, torch.float32, (k,))
    return sc, bi
