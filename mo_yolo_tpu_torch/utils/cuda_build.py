"""Build the port's CUDA kernels with nvcc, and its host C code with the
host compiler, and load them with ctypes.

Each source under `ops/csrc/` exposes a plain C entry point. It is compiled
on first use into `build/torch_kernels/` at the repository root (listed in
`.gitignore`), under a name keyed by a hash of the source, the headers
(`*.cuh`) beside it and the flags, so a changed source rebuilds and an
unchanged one loads at once. Nothing is built at import time: the CPU tests
import every module.

`call` runs an entry point on the current stream of a tensor's device: the
launch path every wrapper shares, kept short because a kernel of the main
path runs for less time than the host takes to launch it.

`load_c` does the same for one plain C source run on the host (the frame
decoders `data/csrc/decode.c` and `jpeg.c`, the resize, the
augmentations): compiled with `cc` (which nvcc needs, so the card's
machine has one) into `build/host_libs/`, keyed by a hash of the source,
the flags and the libraries it links.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "ops" / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / \
    "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}   # name -> nvcc's output (ptxas register use)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def library_path(name: str) -> Path:
    key = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that is not built yet, one nvcc process
    per source, all started together. Raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out = {}
    for name in names:
        lib = library_path(name)
        out[name] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library for `ops/csrc/<name>.cu`, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _loaded[name] = lib
    return lib


def call(fn: Callable[..., int], where, *args) -> int:
    """`fn(*args, stream)` with the raw current stream of the CUDA device
    `where` (a tensor on it, or a `torch.device`), as PyTorch's generated
    code asks for it (`torch._C._cuda_getCurrentRawStream`), so that the
    kernel runs in stream order with PyTorch's work and inside CUDA-graph
    capture. `torch.cuda.device` is entered only when that device is not
    the current one. Returns what `fn` returns."""
    current = torch._C._cuda_getDevice()
    if isinstance(where, torch.Tensor):
        index = where.get_device()
    else:
        index = current if where.index is None else where.index
    if index == current:
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def bind(lib: ctypes.CDLL, symbol: str, argtypes, restype=ctypes.c_int):
    """The C function `symbol` of `lib`, its argument types set once
    (ctypes passes an unset pointer argument as a 32-bit int)."""
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


def entry(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """The C function `symbol` of `ops/csrc/<name>.cu`, bound once."""
    return bind(load(name), symbol, argtypes, restype)


# ------------------------------------------------------------ host C code

HOST_BUILD_DIR = BUILD_DIR.parent / "host_libs"
CC_FLAGS = ("-O2", "-std=c99", "-ffp-contract=off", "-shared", "-fPIC")

_loaded_c: Dict[tuple, ctypes.CDLL] = {}


def _cc() -> str:
    for name in ("cc", "gcc", "clang"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C compiler (cc, gcc or clang) found: it is "
                       "needed to build the port's host code")


def missing_c_deps(libs: Sequence[str] = ()) -> List[str]:
    """Those of `libs` (names as for -l) the loader cannot find, as
    "libz"."""
    return [f"lib{lib}" for lib in libs
            if ctypes.util.find_library(lib) is None]


def load_c(src: Path, libs: Sequence[str] = ()) -> ctypes.CDLL:
    """The shared library built from the C file `src`, linked with
    -l`libs`, building it if needed. Raises naming whatever of `libs`
    cannot be found, and with the compiler's output if the build fails."""
    key = (str(src), tuple(libs))
    lib = _loaded_c.get(key)
    if lib is not None:
        return lib
    missing = missing_c_deps(libs)
    if missing:
        raise RuntimeError(f"building {src.name} needs {', '.join(missing)}, "
                           f"which this machine does not have")
    flags = CC_FLAGS
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(flags + tuple(libs)).encode())
    out = HOST_BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_cc(), *flags, "-o", str(tmp), str(src),
               *(f"-l{lib}" for lib in libs)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"building {src.name} failed: cc exited "
                               f"{proc.returncode}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    lib = _loaded_c[key] = ctypes.CDLL(str(out))
    return lib
