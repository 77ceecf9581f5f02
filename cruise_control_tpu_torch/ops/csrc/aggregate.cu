// Per-broker channel sums for the aggregate recompute, written for Hopper.
//
// Replaces the TPU kernel cruise_control_tpu/ops/pallas_aggregate.py
// (_pallas_sums / _kernel_impl): out[b, k] = sum over r with broker[r] == b
// of channels[r, k], i.e. segment_sum(channels, broker, B).  The TPU kernel
// builds a one-hot [CHUNK, B] tile and multiplies on the MXU into a VMEM
// accumulator revisited by a sequential grid.  On Hopper the grid runs in
// parallel with no carried state, so the design is:
//
//   pass 1  grid (row_blocks, b_tiles).  Each block zeroes a shared-memory
//           accumulator [b_tile, K], streams its contiguous slice of replica
//           rows once, and adds every row whose broker falls in its tile with
//           shared-memory float atomics.  Rows whose broker lies outside
//           [0, B) match no tile and are skipped.  The block writes its
//           partial [b_tile, K] to scratch laid out [row_blocks, B, K].
//   pass 2  one thread per (b, k) sums the row_blocks partials in block
//           order, so the cross-block order is fixed.
//
// Brokers are tiled over grid.y when B * K * 4 bytes exceeds the wrapper's
// shared-memory budget, so any B works (each tile re-reads the rows).
//
// Bound: memory.  The function must read R * (K * 4 + 4) bytes and write
// B * K * 4; it does R * K adds, far below the card's float32 rate.  At the
// slice's scale (R ~ 50K, K = 8, B = 200) that is ~1.8 MB, about 0.5 us at
// 3.35 TB/s, so a launch costs more than the bytes; at north-star scale
// (R ~ 1M, B = 2,600) ~36 MB, about 11 us.  The design reads each row once
// per broker tile, coalesced (neighbouring threads take neighbouring rows),
// and keeps the accumulator out of device memory; scratch traffic is
// row_blocks * B * K * 4 bytes each way.
//
// Numerics: the shared-memory float atomics make the low bits of each float
// sum depend on the order in which a block's threads land, which varies from
// run to run.  Count channels (0/1 values) stay exact below 2^24 per broker.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;  // channels loaded per group (K = 8 on the main path)

__global__ void channel_sums_partial(const float* __restrict__ channels,
                                     const int* __restrict__ broker,
                                     float* __restrict__ partial,
                                     int num_rows, int num_channels,
                                     int num_brokers, int rows_per_block,
                                     int b_tile) {
  extern __shared__ float acc[];  // [b_tile, num_channels]
  const int b0 = blockIdx.y * b_tile;
  const int nb = min(b_tile, num_brokers - b0);
  const int n_acc = nb * num_channels;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();

  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r_end = r0 + rows_per_block;
  const long long r1 = r_end < num_rows ? r_end : static_cast<long long>(num_rows);
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int b = broker[r] - b0;
    if (b < 0 || b >= nb) continue;  // another tile's broker, or out of [0, B)
    const float* row = channels + r * num_channels;
    float* dst = acc + b * num_channels;
    // Load a group of channels into registers before adding any of them:
    // interleaved load/atomic pairs wait out one memory latency each.
    for (int k0 = 0; k0 < num_channels; k0 += kGroup) {
      float v[kGroup] = {};
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        if (k0 + j < num_channels) v[j] = row[k0 + j];
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        if (k0 + j < num_channels) atomicAdd(dst + k0 + j, v[j]);
    }
  }
  __syncthreads();

  float* out = partial
      + (static_cast<size_t>(blockIdx.x) * num_brokers + b0) * num_channels;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) out[i] = acc[i];
}

__global__ void channel_sums_reduce(const float* __restrict__ partial,
                                    float* __restrict__ out, int row_blocks,
                                    int n_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  float s = 0.0f;
  for (int j = 0; j < row_blocks; ++j) s += partial[static_cast<size_t>(j) * n_out + i];
  out[i] = s;
}

}  // namespace

// out: f32[num_brokers, num_channels]; scratch: f32[row_blocks, num_brokers,
// num_channels], unused when row_blocks == 1.  Launches on `stream` and
// returns the CUDA error of the launches (0 on success).
extern "C" int cc_broker_channel_sums(const float* channels, const int* broker,
                                      float* out, float* scratch, int num_rows,
                                      int num_channels, int num_brokers,
                                      int row_blocks, int b_tile,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b_tiles = (num_brokers + b_tile - 1) / b_tile;
  const size_t smem = static_cast<size_t>(b_tile) * num_channels * sizeof(float);
  // Past the default 48 KB a launch needs the dynamic shared-memory
  // attribute, set on the current device (only large broker axes get here).
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(channel_sums_partial,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int rows_per_block = (num_rows + row_blocks - 1) / row_blocks;
  float* partial = row_blocks == 1 ? out : scratch;
  channel_sums_partial<<<dim3(row_blocks, b_tiles), kThreads, smem, s>>>(
      channels, broker, partial, num_rows, num_channels, num_brokers,
      rows_per_block, b_tile);
  err = cudaGetLastError();
  if (err != cudaSuccess || row_blocks == 1) return static_cast<int>(err);
  const int n_out = num_brokers * num_channels;
  channel_sums_reduce<<<(n_out + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      scratch, out, row_blocks, n_out);
  return static_cast<int>(cudaGetLastError());
}
