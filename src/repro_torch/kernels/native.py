"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each source in `src/repro_torch/csrc/` becomes one shared library with a
plain C interface, compiled for Hopper (`sm_90a`) into `build/kernels/` at
the repository root. A library's file name carries a hash of its source, the
shared header and the flags, so an edited kernel rebuilds and an unchanged
one is reused. `build()` starts one `nvcc` per missing library, all at once,
and waits for them; the first launch of a kernel builds what is missing.

Nothing here runs at import: the CPU tests import every module of the port,
and this machine-independent layer must import without a GPU or a compiler.
A wrapper that is handed a CUDA tensor launches its kernel or raises —
a missing `nvcc` or a failed build is an error, never a silent fallback.

Launch counts: each wrapper calls `count_launch(name)` right after its
kernel launched, and only there, so a run can prove which kernels its main
path went through (`launch_counts()`, `reset_launch_counts()`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# -Xptxas=-v: the build log reports each kernel's registers, spills and
# shared memory (`build()["log"]`)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# dtype codes of csrc/common.cuh (repro::DType)
DTYPE_CODES = {"float32": 0, "bfloat16": 1, "float16": 2}


def dtype_code(dtype) -> int:
    """The kernel ABI's code for a torch dtype."""
    return DTYPE_CODES[str(dtype).removeprefix("torch.")]


_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float

# kernel -> (source file, C entry point, argtypes)
KERNELS: dict[str, tuple[str, str, list]] = {
    "anemm": ("anemm.cu", "anemm_launch",
              [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "flash": ("flash_attention.cu", "flash_attention_launch",
              [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I]
              + [_I64] * 9 + [_I, _I, _F, _I, _P]),
    # two sources, one body (decode_attention.cuh): the monolithic and the
    # paged cache, built side by side
    "decode_attention": ("decode_attention.cu", "decode_attention_launch",
                         [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _F, _I, _I, _P]),
    "paged_decode_attention": ("paged_decode_attention.cu", "paged_decode_attention_launch",
                               [_P] * 7 + [_I] * 6 + [_I64, _I64, _I, _F, _I, _P]),
    "palette": ("palette_matmul.cu", "palette_matmul_launch",
                [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "sparse": ("sparse_matmul.cu", "sparse_matmul_launch",
               [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    # one source, two entry points: the chain and the tree verify/accept
    "specdec": ("specdec.cu", "specdec_launch", [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "specdec_tree": ("specdec.cu", "specdec_tree_launch",
                     [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "act_lut": ("act_lut.cu", "act_lut_launch", [_P, _P, _P, _I64, _I, _I, _P]),
    "conv2d": ("conv2d.cu", "conv2d_launch", [_P] * 5 + [_I] * 15 + [_P]),
    # one source, two entry points: the avg and the max window reduction
    "avg_pool": ("pool.cu", "avg_pool_launch", [_P, _P] + [_I] * 12 + [_F, _I, _P]),
    "max_pool": ("pool.cu", "max_pool_launch", [_P, _P] + [_I] * 12 + [_F, _I, _P]),
}

_LIBS: dict[str, ctypes.CDLL] = {}
_LAUNCHES: Counter = Counter()


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, for every kernel of the port."""
    return {name: _LAUNCHES[name] for name in KERNELS}


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the port's CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    source = KERNELS[name][0]
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile every missing library of `names` (default: all kernels), one
    nvcc process per source (kernels that share a source share its library),
    all started together. Returns {"seconds": wall, "built": [...], "log":
    {source stem: compiler stderr}}; raises with the compiler's output if any
    build fails."""
    names = list(KERNELS) if names is None else list(names)
    todo = {}
    for n in names:
        path = library_path(n)
        if not path.exists():
            todo.setdefault(Path(KERNELS[n][0]).stem, (n, path))
    t0 = time.perf_counter()
    log: dict[str, str] = {}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        for stem, (name, out) in todo.items():
            tmp = out.parent / f".{out.stem}.{os.getpid()}.so"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / KERNELS[name][0])]
            procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            text, _ = proc.communicate()
            log[name] = text
            if proc.returncode != 0:
                failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{text}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)   # atomic: a reader never sees half a file
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "built": sorted(todo), "log": log}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if missing."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not path.exists():
        build([name])
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, KERNELS[name][1])
    fn.argtypes = KERNELS[name][2]
    fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def launch(name: str, *args) -> None:
    """Call kernel `name`'s C entry point and raise on a refused launch;
    count the launch only once it was accepted."""
    lib = library(name)
    err = getattr(lib, KERNELS[name][1])(*args)
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {err} ({msg})")
    count_launch(name)
