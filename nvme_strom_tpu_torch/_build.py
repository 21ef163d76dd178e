"""Build-at-first-use of the port's two native libraries.

* ``libstrom_io.so`` — the port's own copy of the C++ io_uring/O_DIRECT
  engine, compiled from the repository's ``csrc/strom_io.cc`` with the
  flags of ``csrc/Makefile``.  Needs only ``g++``.
* ``libstrom_torch_kernels.so`` — the hand-written Hopper kernels in
  ``nvme_strom_tpu_torch/csrc/*.cu``, compiled by ``nvcc`` for
  ``sm_90a`` (one ``nvcc -c`` per source, all started together, then
  one link against libcuda, whose ``cuTensorMapEncodeTiled`` the
  tensor-core flash kernels call) and bound with ctypes.  Needs the CUDA
  toolkit.

Both land in ``build/torch_kernels/`` at the repository root and are
rebuilt whenever the SHA-256 of their sources and flags changes.  A
file lock serialises concurrent builders (several test workers, say),
and a finished library is moved into place atomically.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parent
_ROOT = _PKG.parent
BUILD_DIR = _ROOT / "build" / "torch_kernels"
KERNEL_SRC = _PKG / "csrc"
ENGINE_SRC = _ROOT / "csrc"

GXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-pthread", "-shared"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]
#: the link of the kernel library: the tensor-core flash kernels encode
#: their TMA tensor maps with libcuda's cuTensorMapEncodeTiled
NVCC_LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                   "-lcuda"]

#: seconds each library's build took in this process (0.0 = up to date)
build_seconds: Dict[str, float] = {}

_lock = threading.Lock()
_engine_lib: Optional[ctypes.CDLL] = None
_kernel_lib: Optional[ctypes.CDLL] = None


def _digest(paths: List[Path], flags: List[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _run(cmds: List[List[str]]) -> None:
    """Run the commands concurrently; raise with the compiler's output
    if any of them fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    errors = []
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"$ {' '.join(c)}\n{out}")
    if errors:
        raise RuntimeError("native build failed:\n" + "\n".join(errors))


def _build(name: str, deps: List[Path], flags: List[str], make) -> Path:
    """Return ``BUILD_DIR/name``, (re)building it with ``make(tmp_out)``
    unless its recorded digest matches ``deps`` + ``flags``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / name
    stamp = BUILD_DIR / (name + ".sha256")
    want = _digest(deps, flags)
    with open(BUILD_DIR / "lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if out.exists() and stamp.exists() and stamp.read_text() == want:
            build_seconds[name] = 0.0
            return out
        t0 = time.monotonic()
        tmp = BUILD_DIR / f".{name}.{os.getpid()}.tmp"
        try:
            make(tmp)
            os.replace(tmp, out)
        finally:
            if tmp.exists():
                tmp.unlink()
        stamp.write_text(want)
        build_seconds[name] = time.monotonic() - t0
    return out


def engine_library() -> ctypes.CDLL:
    """The port's copy of the strom-io engine (built with g++)."""
    global _engine_lib
    with _lock:
        if _engine_lib is None:
            cc = ENGINE_SRC / "strom_io.cc"
            deps = [cc, ENGINE_SRC / "strom_io.h"]

            def make(tmp: Path) -> None:
                cxx = shutil.which("g++")
                if cxx is None:
                    raise RuntimeError("g++ not found: the engine library "
                                       "is built from csrc/strom_io.cc")
                _run([[cxx, *GXX_FLAGS, "-o", str(tmp), str(cc)]])

            path = _build("libstrom_io.so", deps, GXX_FLAGS, make)
            _engine_lib = ctypes.CDLL(str(path), use_errno=True)
        return _engine_lib


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from nvme_strom_tpu_torch/csrc at first use")
    return nvcc


def kernel_library() -> ctypes.CDLL:
    """The hand-written CUDA kernels (built with nvcc for sm_90a), with
    every entry point's ctypes signature declared."""
    global _kernel_lib
    with _lock:
        if _kernel_lib is None:
            sources = sorted(KERNEL_SRC.glob("*.cu"))
            deps = sources + sorted(KERNEL_SRC.glob("*.cuh"))

            def make(tmp: Path) -> None:
                nvcc = _nvcc()
                objs = [BUILD_DIR / f".{s.stem}.{os.getpid()}.o"
                        for s in sources]
                try:
                    _run([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                          for s, o in zip(sources, objs)])
                    _run([[nvcc, "-o", str(tmp), *map(str, objs),
                           *NVCC_LINK_FLAGS]])
                finally:
                    for o in objs:
                        if o.exists():
                            o.unlink()

            path = _build("libstrom_torch_kernels.so", deps,
                          NVCC_FLAGS + NVCC_LINK_FLAGS, make)
            _kernel_lib = _declare(ctypes.CDLL(str(path)))
        return _kernel_lib


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, U64, I, F = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, \
        ctypes.c_float
    S = ctypes.POINTER(ctypes.c_longlong)   # (sb, sh, ss) per tensor
    sigs = {
        "strom_host_register": [P, U64, I, ctypes.POINTER(P)],
        "strom_host_unregister": [P, I],
        "strom_host_device_pointer": [P, I, ctypes.POINTER(P)],
        "strom_h2d_copy": [P, P, U64, P, I],
        # src, dst, n, design (csrc/h2d_copy.cu kDesigns), stream, dev
        "strom_h2d_copy_probe": [P, P, U64, I, P, I],
        # q, k, v, pos, out, ws, b, nkv, g, S, d, width, rows,
        # split_len, dtype, scale, stream, dev
        "strom_decode_attention": [P, P, P, P, P, P, I, I, I, I, I, I, I,
                                   I, I, F, P, I],
        # q, k_pool, v_pool, table, pos, out, ws, b, nkv, g, n_pool,
        # block_k, max_blocks, d, width, rows, split_len, dtype, scale,
        # stream, dev
        "strom_paged_attention": [P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                                  I, I, I, I, F, P, I],
        # q, k, v, out, lse, strides, b, h, s, skv, d, dtype, causal,
        # scale, stream, dev
        "strom_flash_fwd": [P, P, P, P, P, S, I, I, I, I, I, I, I, F, P, I],
        # q, k, v, dout, lse, delta, dq, strides, b, h, s, skv, d, dtype,
        # causal, scale, stream, dev
        "strom_flash_bwd_dq": [P, P, P, P, P, P, P, S, I, I, I, I, I, I, I,
                               F, P, I],
        # q, k, v, dout, lse, delta, dk, dv, strides, ... as above
        "strom_flash_bwd_dkv": [P, P, P, P, P, P, P, P, S, I, I, I, I, I,
                                I, I, F, P, I],
        # kernel (0 forward, 1 dQ, 2 dK/dV), dtype
        "strom_flash_route": [I, I],
        # slots, flags, ranks (host arrays), n_here, n, remote_right,
        # slot_bytes, blocks, base, budget_ns, err, err_host, stream, dev
        "strom_ici_ring": [P, P, P, I, I, U64, U64, I, ctypes.c_uint,
                           ctypes.c_ulonglong, P, P, P, I],
        # dev, blocks, chunk (both written)
        "strom_ici_ring_capacity": [I, ctypes.POINTER(I),
                                    ctypes.POINTER(ctypes.c_uint)],
        "strom_stream_synchronize": [P, I],
        "strom_enable_peer_access": [I, I],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.strom_cuda_error_string.argtypes = [ctypes.c_int]
    lib.strom_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel-library entry point returned a CUDA error."""
    if rc != 0:
        msg = kernel_library().strom_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
