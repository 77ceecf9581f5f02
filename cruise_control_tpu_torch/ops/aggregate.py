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
interface at first use, under ``ops/_build/`` (or where
:func:`set_build_dir` points, which the persistent compile cache does), and
bound with ``ctypes``.  The source note in ``aggregate.cu`` gives the design and its memory bound.
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
from typing import Callable, NamedTuple, Optional

import torch

#: Kernel launches made by :func:`broker_channel_sums` since the last reset
#: (a run sets it to 0, drives the path, and reads it back).
LAUNCHES = 0

_SRC = Path(__file__).with_name("csrc") / "aggregate.cu"
_BUILD_DIR = Path(__file__).with_name("_build")
_ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

#: Threads per block, at most (``kMaxThreads`` in aggregate.cu).
MAX_THREADS = 1024
#: The most shared memory one block may opt into on sm_90 (227 KB).
SMEM_PER_BLOCK = 232_448
# An SM's shared memory (228 KB), and the runtime's share of it per block.
_SMEM_PER_SM = 233_472
_SMEM_RESERVED = 1_024
#: Up to this many rows, GLOBAL: BLOCK's zeroing and flush cost more than
#: its shared-memory adds save (chip_smoke.py's crossover phase, PERF.md).
GLOBAL_MAX_ROWS = 16_384
# Threads per block at least (and GLOBAL's).
_MIN_THREADS = 256

#: Kernel variants (``Mode`` in aggregate.cu): a block's shared-memory
#: accumulator per broker tile; reductions straight into ``out``.
BLOCK, GLOBAL = 0, 1


class LaunchPlan(NamedTuple):
    """The shape of one launch: grid ``(grid, tiles)`` of ``threads``
    threads; the blocks of tile t own brokers ``[t * broker_slice, ... +
    broker_slice)`` (clipped to ``[0, B)``) and write them to ``out``."""
    grid: int          # blocks along the rows; 0 launches nothing
    tiles: int         # broker tiles (grid.y): 1 unless B exceeds the accumulator
    threads: int       # threads per block
    broker_slice: int  # brokers each tile owns
    mode: int          # BLOCK or GLOBAL
    vector: bool       # K % 4 == 0: float4 loads and reductions (on 16-byte aligned rows)
    smem_bytes: int    # shared memory per block


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def acc_stride(num_channels: int) -> int:
    """Floats per broker in the shared-memory accumulator: odd, so a warp's
    adds to one channel of 32 brokers fall in 32 banks."""
    return num_channels | 1


def modeled_resident(num_sms: int, threads: int, smem_bytes: int) -> int:
    """Blocks of ``threads`` threads and ``smem_bytes`` each resident on the
    card at once, from its thread and shared-memory limits (registers
    aside); the wrapper asks the CUDA occupancy API instead."""
    return num_sms * min(2048 // threads, _SMEM_PER_SM // (smem_bytes + _SMEM_RESERVED))


def launch_plan(num_rows: int, num_channels: int, num_segments: int, num_sms: int,
                resident: Optional[Callable[[int, int, int], int]] = None) -> LaunchPlan:
    """The launch for ``channels`` f32[num_rows, num_channels] onto
    ``num_segments`` brokers, on a card of ``num_sms`` SMs.

    GLOBAL up to :data:`GLOBAL_MAX_ROWS` rows, else BLOCK with broker tiles
    where one block's accumulator cannot hold the broker axis; threads per
    block the power of two nearest above one row per thread on one block
    per SM (256 to 1,024); at most one block per SM per tile, and no more
    blocks than the rows fill.  ``resident(mode, threads, broker_slice)``
    gives the blocks of that shape that fit on the card at once (default
    :func:`modeled_resident`): the launch is cooperative, so no grid
    exceeds it."""
    k, b = num_channels, num_segments
    row_bytes = acc_stride(k) * 4
    if row_bytes > SMEM_PER_BLOCK:
        raise ValueError(f"{k} channels exceed the kernel's shared-memory budget")
    vector = k % 4 == 0
    mode = GLOBAL if num_rows <= GLOBAL_MAX_ROWS else BLOCK
    per_sm = _ceil(num_rows, num_sms)  # rows per SM: about one per thread
    threads = (_MIN_THREADS if mode == GLOBAL else
               min(MAX_THREADS, max(_MIN_THREADS, 1 << max(0, per_sm - 1).bit_length())))
    if num_rows == 0 or b == 0:  # the memset alone
        return LaunchPlan(0, 1, threads, b, mode, vector, 0)
    tiles, slice_ = 1, b
    if mode == BLOCK:
        tiles = _ceil(b, SMEM_PER_BLOCK // row_bytes)
        slice_ = _ceil(b, tiles)
    smem = 0 if mode == GLOBAL else slice_ * row_bytes
    fit = (resident(mode, threads, slice_) if resident
           else modeled_resident(num_sms, threads, smem))
    if mode == BLOCK:
        fit = min(fit, num_sms)
    grid = max(1, min(_ceil(num_rows, threads), fit // tiles))
    return LaunchPlan(grid, tiles, threads, slice_, mode, vector, smem)


class _CPlan(ctypes.Structure):
    """``Plan`` in aggregate.cu."""
    _fields_ = [("num_rows", ctypes.c_longlong),
                *[(name, ctypes.c_int) for name in (
                    "num_channels", "num_brokers", "grid", "tiles", "slice", "threads",
                    "mode")]]


_fn = None        # the loaded cc_broker_channel_sums
_resident = None  # the loaded cc_resident_blocks
_devices = 0      # CUDA devices, counted at load
_lib_lock = threading.Lock()
_plans: dict = {}
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


def _load():
    """Build and load the library once; later calls read the module global."""
    global _fn, _resident, _devices
    with _lib_lock:
        if _fn is None:
            lib = ctypes.CDLL(str(build()))
            res = lib.cc_resident_blocks
            res.argtypes = [ctypes.c_int] * 5
            res.restype = ctypes.c_int
            fn = lib.cc_broker_channel_sums
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _devices = torch.cuda.device_count()
            _resident = res
            _fn = fn
    return _fn


def set_build_dir(path) -> bool:
    """Build and load the library under ``path`` from now on (the one way to
    move it; ``compilesvc.cache.PersistentCompileCache.activate`` calls it).
    Returns False, and moves nothing, once this process has loaded the
    library: the new place then serves later processes only."""
    global _BUILD_DIR
    with _lib_lock:
        if _fn is not None:
            return False
        _BUILD_DIR = Path(path)
        return True


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


def plan_for(num_rows: int, num_channels: int, num_segments: int,
             device: torch.device) -> LaunchPlan:
    """The cached :func:`launch_plan` for this shape on ``device``, sized by
    the CUDA occupancy API."""
    return _planned(num_rows, num_channels, num_segments, device)[0]


def _planned(num_rows, num_channels, num_segments, device):
    """(plan, its C struct, the struct's address), cached per shape and
    device."""
    key = (num_rows, num_channels, num_segments, device.index)
    got = _plans.get(key)
    if got is None:
        vec = int(num_channels % 4 == 0)

        def resident(mode: int, threads: int, broker_slice: int) -> int:
            if _resident is None:
                _load()
            with torch.cuda.device(device):
                n = _resident(mode, vec, threads, num_channels, broker_slice)
            if n <= 0:
                raise RuntimeError(f"aggregate kernel occupancy query failed: {n}")
            return n

        sms = torch.cuda.get_device_properties(device).multi_processor_count
        plan = launch_plan(num_rows, num_channels, num_segments, sms, resident=resident)
        cplan = _CPlan(num_rows, num_channels, num_segments, plan.grid, plan.tiles,
                       plan.broker_slice, plan.threads, plan.mode)
        got = (plan, cplan, ctypes.addressof(cplan))
        _plans[key] = got
    return got


def _launch(channels, broker, out, plan, cplan_addr):
    global LAUNCHES
    fn = _fn or _load()
    index = channels.get_device()
    if _devices > 1 and index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _launch(channels, broker, out, plan, cplan_addr)
    ch, o = channels.data_ptr(), out.data_ptr()
    # float4 loads and reductions need 16-byte aligned rows: a view with a
    # storage offset takes the scalar path.
    err = fn(ch, broker.data_ptr(), o, cplan_addr, plan.vector and not (ch | o) & 15,
             torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"aggregate kernel launch failed: CUDA error {err}")
    if plan.grid:
        LAUNCHES += 1


def broker_channel_sums(channels: torch.Tensor, broker: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """f32[num_segments, K]: per-broker sums of ``channels`` (f32[R, K]) by
    ``broker`` (i32[R]).  CPU tensors take the plain version; CUDA tensors
    launch the kernel, or raise."""
    if channels.dim() != 2 or broker.dim() != 1 or broker.shape[0] != channels.shape[0]:
        raise ValueError(f"channels [R, K] and broker [R] expected, got "
                         f"{tuple(channels.shape)} and {tuple(broker.shape)}")
    if not channels.is_cuda:
        if channels.device != broker.device:
            raise ValueError(f"channels on {channels.device}, broker on {broker.device}")
        if channels.device.type == "cpu":
            return broker_channel_sums_plain(channels, broker, num_segments)
        raise ValueError(f"no kernel for device {channels.device}")
    index = channels.get_device()
    if not broker.is_cuda or broker.get_device() != index:
        raise ValueError(f"channels on {channels.device}, broker on {broker.device}")
    if channels.dtype != torch.float32 or broker.dtype != torch.int32:
        raise TypeError(f"f32 channels and i32 broker expected, got "
                        f"{channels.dtype} and {broker.dtype}")
    if not (channels.is_contiguous() and broker.is_contiguous()):
        raise ValueError("channels and broker must be contiguous")
    if torch.cuda.is_current_stream_capturing():
        # A replayed graph would launch it uncounted, and a cooperative
        # launch is kept out of graphs: callers recompute aggregates eagerly.
        raise RuntimeError("the aggregate kernel is not launched inside a CUDA graph capture")
    r, k = channels.shape
    got = _plans.get((r, k, num_segments, index))
    if got is None:
        got = _planned(r, k, num_segments, channels.device)
    out = torch.empty((num_segments, k), dtype=torch.float32, device=channels.device)
    if num_segments and k:
        _launch(channels, broker, out, got[0], got[2])
    return out
