// Per-broker channel sums for the aggregate recompute, written for Hopper.
//
// Replaces the TPU kernel cruise_control_tpu/ops/pallas_aggregate.py
// (_pallas_sums / _kernel_impl): out[b, k] = sum over r with broker[r] == b
// of channels[r, k], i.e. segment_sum(channels, broker, B); rows whose
// broker lies outside [0, B) add nothing.  The TPU kernel builds a one-hot
// [CHUNK, B] tile and multiplies on the MXU into a VMEM accumulator that a
// sequential grid carries.  Hopper blocks run in parallel with nothing
// carried, and a block has at most 227 KB of shared memory.
//
// Bound: memory.  The function must read R * (K * 4 + 4) bytes and write
// B * K * 4; its R * K adds are far below the card's float32 rate.  At the
// main path's shape (R ~ 50K, K = 8, B = 200) that is ~1.8 MB, ~0.5 us at
// 3.35 TB/s, so fixed launch costs dominate; at north-star scale (R ~ 1M,
// B = 2,600) ~36 MB, ~11 us.  What limits this design on the card is the
// adds: a float atomicAdd on shared memory compiles to a compare-and-swap
// loop (ATOMS.CAST.SPIN), so R * K of them are latency-bound round trips.
//
// Design: one launch per call on the caller's stream, from one C call; no
// partial tensor, no second pass.  The launch is cooperative (the plan
// never makes a grid larger than fits on the card at once): the grid first
// zeroes out itself and meets at grid.sync(), so no memset is needed.  R = 0
// zeroes out with one cudaMemsetAsync on the same stream and launches
// nothing.  The wrapper's launch_plan (aggregate.py) picks the shape.
//
//   BLOCK    Each block zeroes a shared-memory accumulator for a tile of
//            brokers, one row of K floats per broker at an odd stride (K or
//            K + 1, so that a warp's adds to channel k of 32 random brokers
//            spread over the 32 banks), and grid-strides over the rows.  A
//            thread keeps kUnroll rows in flight: it starts their broker
//            loads, then the channel loads of the rows its tile owns (two
//            float4 loads per row at K = 8 when K % 4 == 0 and the rows are
//            16-byte aligned, scalar loads otherwise), then their atomics.
//            The grid is at most one block per SM and as wide as the rows
//            give each thread about one row; up to 1,024 threads per block
//            keep enough compare-and-swap loops in flight.  After
//            __syncthreads() the block adds its non-zero sums into out with
//            global reductions (float4 red.global.add on the vector path).
//            A broker axis beyond one block's accumulator is tiled over
//            grid.y; every tile reads each row's broker id, and only the
//            owning tile loads the row's channels, so channels are read once.
//            (Splitting the broker axis over a thread-block cluster instead,
//            with adds through distributed shared memory, measured several
//            times slower: PERF.md.)
//   GLOBAL   No shared memory: each row's channels go straight into out
//            with global reductions.  The plan takes it for small inputs,
//            where BLOCK's zeroing and flush cost more than they save.
//            Hot brokers serialize its reductions on a few L2 lines.
//
// Numerics: shared-memory atomics land in whatever order a block's threads
// reach them, and the global reductions in whatever order blocks flush, so
// the low bits of a float sum vary from run to run (the first design was
// already order-dependent inside a block; the cross-block order, fixed
// there by its second pass, is not fixed now).  Any order stays within the
// worst-case f32 rounding bound of the float64 sum, which chip_smoke.py
// checks, and on zero-mean channels within sqrt(n) * 2^-24 * sum |x| of it.
// Count channels (0/1 values) stay exact below 2^24 per broker.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

// One launch's shape (the wrapper's _CPlan); outside the anonymous
// namespace, so that the extern "C" entry point taking it stays exported.
struct Plan {
  long long num_rows;
  int num_channels, num_brokers, grid, tiles, slice, threads, mode;
};

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kUnroll = 4;        // rows in flight per thread
constexpr int kGroup = 8;         // channels of a row held in registers at once
constexpr int kSmemMax = 232448;  // the most a block may opt into on sm_90
constexpr int kMaxDevices = 64;

// = the wrapper's BLOCK, GLOBAL.
enum Mode { kBlock = 0, kGlobal = 1, kModes = 2 };

// Accumulator stride: odd, so that 32 brokers' channel k fall in 32 banks.
__host__ __device__ __forceinline__ int acc_stride(int k) { return k | 1; }

template <bool kVec>
__device__ __forceinline__ void load_group(const float* __restrict__ row, int k0,
                                           int num_channels, float (&v)[kGroup]) {
  if constexpr (kVec) {
    // num_channels % 4 == 0 and the row is 16-byte aligned: k0 + 4 <= K.
    const float4 a = __ldg(reinterpret_cast<const float4*>(row + k0));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    if (k0 + 8 <= num_channels) {
      const float4 c = __ldg(reinterpret_cast<const float4*>(row + k0 + 4));
      v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
    } else {
      v[4] = v[5] = v[6] = v[7] = 0.0f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      v[j] = k0 + j < num_channels ? __ldg(row + k0 + j) : 0.0f;
  }
}

// grid (blocks, tiles); slice = brokers a block owns.  A cooperative
// launch: every block is resident, so grid.sync() orders the zeroing of out
// before any reduction into it.
template <bool kVec, int kMode>
__global__ void __launch_bounds__(kMaxThreads)
channel_sums(const float* __restrict__ channels, const int* __restrict__ broker,
             float* __restrict__ out, long long num_rows, int num_channels,
             int num_brokers, int slice) {
  extern __shared__ float acc[];
  cg::grid_group grid = cg::this_grid();
  const unsigned long long n_out = static_cast<unsigned long long>(num_brokers) * num_channels;
  for (unsigned long long i = grid.thread_rank(); i < n_out; i += grid.size()) out[i] = 0.0f;
  // Before any reduction; here rather than before the flush, so that
  // blocks still flush as they finish instead of all at once.
  grid.sync();
  const int stride_k = acc_stride(num_channels);
  // Brokers [tile0, tile0 + tile_n) are this block's (its grid.y tile).
  const int tile0 = blockIdx.y * slice;
  const int tile_n = min(slice, num_brokers - tile0);
  if constexpr (kMode == kBlock) {
    for (int i = threadIdx.x; i < slice * stride_k; i += blockDim.x) acc[i] = 0.0f;
    __syncthreads();  // zeroed before any add
  }

  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       r0 < num_rows; r0 += step * kUnroll) {
    int b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + u * step;
      const int lb = r < num_rows ? __ldg(broker + r) - tile0 : -1;
      b[u] = lb >= 0 && lb < tile_n ? lb : -1;  // -1: out of [0, B), or another tile's
    }
    for (int k0 = 0; k0 < num_channels; k0 += kGroup) {
      // Only the tile that owns a row loads its channels.
      float v[kUnroll][kGroup];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (b[u] >= 0) {
          load_group<kVec>(channels + (r0 + u * step) * num_channels, k0, num_channels, v[u]);
        } else {
#pragma unroll
          for (int j = 0; j < kGroup; ++j) v[u][j] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int lb = b[u];
        if (lb < 0) continue;
        if constexpr (kMode == kGlobal) {
          float* dst = out + static_cast<size_t>(lb) * num_channels + k0;
          if constexpr (kVec) {
#pragma unroll
            for (int h = 0; h < kGroup; h += 4) {
              const float4 x = make_float4(v[u][h], v[u][h + 1], v[u][h + 2], v[u][h + 3]);
              if (k0 + h < num_channels
                  && (x.x != 0.0f || x.y != 0.0f || x.z != 0.0f || x.w != 0.0f))
                atomicAdd(reinterpret_cast<float4*>(dst + h), x);
            }
          } else {
#pragma unroll
            for (int j = 0; j < kGroup; ++j)
              if (k0 + j < num_channels && v[u][j] != 0.0f) atomicAdd(dst + j, v[u][j]);
          }
        } else {
          float* dst = acc + lb * stride_k + k0;
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            if (k0 + j < num_channels) atomicAdd(dst + j, v[u][j]);
        }
      }
    }
  }
  if constexpr (kMode == kBlock) {
    __syncthreads();  // every add has landed

    const int lo = tile0;
    const int count = tile_n;
    if constexpr (kVec) {
      const int quads = num_channels / 4;
      float4* dst = reinterpret_cast<float4*>(out + static_cast<size_t>(lo) * num_channels);
      for (int i = threadIdx.x; i < count * quads; i += blockDim.x) {
        const float* a = acc + (i / quads) * stride_k + (i % quads) * 4;
        const float4 x = make_float4(a[0], a[1], a[2], a[3]);
        if (x.x != 0.0f || x.y != 0.0f || x.z != 0.0f || x.w != 0.0f)
          atomicAdd(dst + i, x);
      }
    } else {
      float* dst = out + static_cast<size_t>(lo) * num_channels;
      for (int i = threadIdx.x; i < count * num_channels; i += blockDim.x) {
        const float x = acc[(i / num_channels) * stride_k + i % num_channels];
        if (x != 0.0f) atomicAdd(dst + i, x);
      }
    }
  }
}

using Kernel = void (*)(const float*, const int*, float*, long long, int, int, int);

Kernel pick(int mode, int vec) {
  static const Kernel table[kModes][2] = {
      {channel_sums<false, kBlock>, channel_sums<true, kBlock>},
      {channel_sums<false, kGlobal>, channel_sums<true, kGlobal>},
  };
  return table[mode][vec ? 1 : 0];
}

// Opt every variant into the whole shared memory, once per device.
cudaError_t configure() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  for (int mode = 0; mode < kModes; ++mode)
    for (int vec = 0; vec < 2; ++vec) {
      err = cudaFuncSetAttribute(pick(mode, vec),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
      if (err != cudaSuccess) return err;
    }
  if (dev < kMaxDevices) done[dev] = true;
  return cudaSuccess;
}

size_t smem_bytes(int mode, int num_channels, int slice) {
  return mode == kGlobal ? 0 : static_cast<size_t>(slice) * acc_stride(num_channels) * sizeof(float);
}

}  // namespace

// Blocks of this variant (`threads` threads each, with the accumulator of
// `slice` brokers) that fit on the current device at once, or minus a CUDA
// error.
extern "C" int cc_resident_blocks(int mode, int vec, int threads, int num_channels,
                                  int slice) {
  cudaError_t err = configure();
  if (err != cudaSuccess) return -static_cast<int>(err);
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pick(mode, vec), threads, smem_bytes(mode, num_channels, slice));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}

// out: f32[num_brokers, num_channels].  Launches one kernel of grid (grid,
// tiles) on `stream` that zeroes out and sums into it (a cooperative
// launch); grid == 0 zeroes out with cudaMemsetAsync on the same stream
// instead and launches nothing.  vec: float4 loads and reductions (K % 4 ==
// 0 and 16-byte aligned rows).  Returns the CUDA error of the calls (0 on
// success).
extern "C" int cc_broker_channel_sums(const float* channels, const int* broker,
                                      float* out, const Plan* p, int vec,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p->grid == 0)
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(p->num_brokers) * p->num_channels * sizeof(float), s));
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p->grid, p->tiles, 1);
  cfg.blockDim = dim3(p->threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(p->mode, p->num_channels, p->slice);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, pick(p->mode, vec), channels, broker, out, p->num_rows,
                     p->num_channels, p->num_brokers, p->slice);
  return static_cast<int>(cudaGetLastError());
}
