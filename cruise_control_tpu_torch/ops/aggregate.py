"""Per-broker channel sums for the aggregate recompute: the Hopper kernel and
its plain version.

``analyzer/context.compute_aggregates`` reduces eight per-replica channels
(4 resource loads, replica/leader counts, potential NW-out, leader bytes-in)
onto their brokers at every aggregate resync.  :func:`broker_channel_sums`
is that reduction: ``out[b, k] = sum of channels[r, k] over rows with
broker[r] == b``; rows whose broker lies outside ``[0, num_segments)`` add
nothing.

On a CUDA tensor it launches the hand-written kernel in
``csrc/aggregate.cu`` (which replaces the TPU kernel
``cruise_control_tpu/ops/pallas_aggregate.py`` ``_pallas_sums``) or raises;
on a CPU tensor it takes :func:`broker_channel_sums_plain`.  The kernel is
compiled with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface at first use, under ``ops/_build/``, and bound with ``ctypes``.
The source note in ``aggregate.cu`` gives the design and its memory bound.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

#: Kernel launches made by :func:`broker_channel_sums` since the last reset
#: (a run sets it to 0, drives the path, and reads it back).
LAUNCHES = 0

_SRC = Path(__file__).with_name("csrc") / "aggregate.cu"
_BUILD_DIR = Path(__file__).with_name("_build")
_ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# Shared-memory accumulator budget per block; a larger broker axis is tiled.
_SMEM_BUDGET = 96 * 1024
# Rows one block streams (before the block cap below spreads them wider).
_ROWS_PER_BLOCK = 512
# Blocks per launch: two per SM of an H100.
_MAX_BLOCKS = 264

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
#: What the build printed (``-Xptxas -v``: registers and shared memory).
BUILD_LOG = ""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the aggregate kernel "
                           "is built from source at first use")
    return found


def build() -> Path:
    """Compile ``csrc/aggregate.cu`` (once per source content) and return
    the shared library's path."""
    global BUILD_LOG
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(_ARCH_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"libcc_aggregate_{tag}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.cc_broker_channel_sums
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def load_seconds() -> float:
    """Build (if needed) and load the kernel library; the seconds it took."""
    t0 = time.monotonic()
    _load()
    return time.monotonic() - t0


def broker_channel_sums_plain(channels: torch.Tensor, broker: torch.Tensor,
                              num_segments: int) -> torch.Tensor:
    """The plain PyTorch version: ``index_add_`` over the in-range rows."""
    ok = (broker >= 0) & (broker < num_segments)
    idx = torch.where(ok, broker, 0).long()
    src = torch.where(ok[:, None], channels, 0.0)
    out = torch.zeros(num_segments, channels.shape[1], dtype=channels.dtype,
                      device=channels.device)
    return out.index_add_(0, idx, src)


def launch_shape(num_rows: int, num_channels: int,
                 num_segments: int) -> tuple[int, int]:
    """(row_blocks, b_tile) of one launch."""
    b_tile = max(1, min(num_segments, _SMEM_BUDGET // (4 * num_channels)))
    b_tiles = -(-num_segments // b_tile)
    row_blocks = max(1, min(-(-num_rows // _ROWS_PER_BLOCK),
                            max(1, _MAX_BLOCKS // b_tiles)))
    return row_blocks, b_tile


def broker_channel_sums(channels: torch.Tensor, broker: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """f32[num_segments, K]: per-broker sums of ``channels`` (f32[R, K]) by
    ``broker`` (i32[R]).  CPU tensors take the plain version; CUDA tensors
    launch the kernel, or raise."""
    if channels.dim() != 2 or broker.dim() != 1 or broker.shape[0] != channels.shape[0]:
        raise ValueError(f"channels [R, K] and broker [R] expected, got "
                         f"{tuple(channels.shape)} and {tuple(broker.shape)}")
    if channels.device != broker.device:
        raise ValueError(f"channels on {channels.device}, broker on {broker.device}")
    if channels.device.type == "cpu":
        return broker_channel_sums_plain(channels, broker, num_segments)
    if channels.device.type != "cuda":
        raise ValueError(f"no kernel for device {channels.device}")
    if channels.dtype != torch.float32 or broker.dtype != torch.int32:
        raise TypeError(f"f32 channels and i32 broker expected, got "
                        f"{channels.dtype} and {broker.dtype}")
    if not (channels.is_contiguous() and broker.is_contiguous()):
        raise ValueError("channels and broker must be contiguous")
    r, k = channels.shape
    if k * 4 > _SMEM_BUDGET:
        raise ValueError(f"{k} channels exceed the kernel's shared-memory budget")
    out = torch.empty(num_segments, k, dtype=torch.float32, device=channels.device)
    if num_segments == 0 or k == 0:
        return out
    row_blocks, b_tile = launch_shape(r, k, num_segments)
    scratch = (torch.empty(row_blocks, num_segments, k, dtype=torch.float32,
                           device=channels.device)
               if row_blocks > 1 else out)
    lib = _load()
    stream = torch.cuda.current_stream(channels.device).cuda_stream
    err = lib.cc_broker_channel_sums(
        channels.data_ptr(), broker.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), r, k, num_segments, row_blocks, b_tile, stream)
    if err != 0:
        raise RuntimeError(f"aggregate kernel launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
