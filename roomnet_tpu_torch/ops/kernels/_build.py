"""Build the port's CUDA kernels with nvcc at first use and load them with ctypes.

Each ``roomnet_tpu_torch/csrc/<name>.cu`` becomes one shared library with a
plain C interface (no PyTorch headers, so nvcc takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/roomnet_tpu_torch/lib<name>-<hash>.so

The file name carries a hash of the sources and flags, so an edited kernel
is rebuilt and a stale library is never loaded. All missing libraries are
compiled together, one nvcc process per source. ``ptxas -v`` (registers,
shared memory, spills) goes to ``<name>.log`` beside the library.

Every C entry returns ``cudaGetLastError()`` after its launch; `check`
raises on anything but 0. Pointers and the stream are ``c_void_p``.

Host libraries (``csrc/<name>.cpp``, today the image decoder roomnet_io)
build the same way with g++ (`build_host`), into the same directory:

    g++ -O3 -fPIC -std=c++17 -shared [-mfma] -o lib<name>-<hash>.so <name>.cpp -ljpeg -lpng
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "roomnet_tpu_torch"
SOURCES = ("conv3x3", "conv1x1", "relu6_pool_bn", "residual_bn", "dense_head")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# -mfma on x86-64: the JAX package's csrc/libroomnet_io.so is built with
# -march=native, and GCC then contracts crop_resize_flip's float lerps into
# FMAs. The same contraction keeps the port's pixels byte-identical to it;
# without it a few pixels round one gray level apart.
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared") + (
    ("-mfma",) if platform.machine() in ("x86_64", "AMD64") else ())
HOST_LIBS = {"roomnet_io": ("-ljpeg", "-lpng")}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels of roomnet_tpu_torch are compiled at first use"
        )
    return found


def _hashed(name: str, flags, sources) -> pathlib.Path:
    digest = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def library_path(name: str) -> pathlib.Path:
    return _hashed(name, NVCC_FLAGS, [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])


def host_library_path(name: str) -> pathlib.Path:
    return _hashed(name, (*GXX_FLAGS, *HOST_LIBS[name]), [CSRC / f"{name}.cpp"])


def build_host(name: str) -> pathlib.Path:
    """The path of csrc/<name>.cpp's host library, compiled with g++ if it is
    not built yet. Raises RuntimeError with the compiler's log on failure."""
    out = host_library_path(name)
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: csrc/{name}.cpp is compiled at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [gxx, *GXX_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp"), *HOST_LIBS[name]]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    (BUILD_DIR / f"{name}.log").write_text(proc.stdout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{name}.cpp build failed (g++ exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def build(names=SOURCES) -> None:
    """Compile every library of `names` that is not built yet, in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu; builds all missing ones first."""
    with _lock:
        if name not in _libs:
            build()
            lib = ctypes.CDLL(str(library_path(name)))
            lib.rn_error_string.argtypes = [ctypes.c_int]
            lib.rn_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def entry(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    fn = getattr(load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, symbol: str, rc: int) -> None:
    if rc != 0:
        msg = load(name).rn_error_string(rc).decode()
        raise RuntimeError(f"{symbol}: CUDA error {rc} ({msg})")


def launch_args(kernel: str, x, *others) -> tuple[int, int, int]:
    """Validate the tensors of one launch and return (dtype code, device
    index, stream handle) for the C entry. `x` carries the io dtype (f32 or
    bf16); every tensor must be a contiguous CUDA tensor on x's device."""
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1}
    if x.device.type != "cuda":
        raise ValueError(f"{kernel}: needs a CUDA or CPU tensor, got {x.device}")
    if x.dtype not in codes:
        raise TypeError(f"{kernel}: io dtype must be float32 or bfloat16, got {x.dtype}")
    for t in (x, *others):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{kernel}: every operand must be contiguous on {x.device}")
    return codes[x.dtype], x.device.index, torch.cuda.current_stream(x.device).cuda_stream
