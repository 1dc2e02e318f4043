// LiDAR BEV occupancy histogram for Hopper (sm_90a).
//
// Replaces: mmfn_tpu/ops/lidar.py:_bev_hist_kernel (launched by
// _bev_hist_pallas). Per cloud, rows [x, y, z, valid] become a
// (256, 256, 2) f32 grid: ix = floor((x + 16) * 8), iy = floor((y + 24) * 8),
// x == 16 / y == 8 go to bin 255, rows out of range or with valid <= 0 are
// dropped, channel 0 holds z <= -2 and channel 1 the rest, counts clip at 5
// and are divided by 5.
//
// What bounds it on the H100: bytes. A tick reads 65,536 points (512 KiB in
// f16) and writes a 512 KiB grid; at 3.35 TB/s that is about 0.3 us, far
// above its few integer operations per point.
//
// Design: the TPU kernel's int8 one-hot matmul is an MXU trick; on Hopper
// this is a scatter. Pass 1 gives one thread per point: it reads the row in
// its transport type (f16 or f32, a template parameter), does the bin math
// in f32 with the same expressions as the JAX kernel's _bin_indices, and
// atomically adds 1 to a zeroed int32 count grid in global memory laid out
// like the output, [b][ix][iy][channel]. Integer atomics make the counts
// exact and independent of order. Pass 2 clips and divides, one thread per
// cell. One cloud's count grid is 512 KiB, more than the 227 KB of shared
// memory a block may use, so a per-block shared-memory histogram is left for
// later. A point whose f32 sum (x + 16) or (y + 24) rounds up to 32 (the
// largest f32 below 16, the two below 8) lands in bin 256: this kernel drops
// it, as the JAX package's XLA path does (its Pallas kernel sends a
// below-split point with y-bin 256 to the above channel's y-bin 0).
// The whole batch goes in one launch pair; any N is allowed and the ragged
// tail of the last block is masked.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kGrid = 256;
constexpr int kCells = kGrid * kGrid * 2;  // per cloud, [ix][iy][channel]
constexpr int kThreads = 256;

__device__ __forceinline__ float4 load_point(const float* pts, long long row) {
    return reinterpret_cast<const float4*>(pts)[row];
}

__device__ __forceinline__ float4 load_point(const __half* pts, long long row) {
    // one 8-byte load of four halves
    const uint2 raw = reinterpret_cast<const uint2*>(pts)[row];
    const __half2 xy = *reinterpret_cast<const __half2*>(&raw.x);
    const __half2 zw = *reinterpret_cast<const __half2*>(&raw.y);
    return make_float4(__low2float(xy), __high2float(xy), __low2float(zw), __high2float(zw));
}

template <typename T>
__global__ void bev_count_kernel(const T* __restrict__ pts, int* __restrict__ counts, int n) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    const int b = blockIdx.y;
    if (i >= n) return;
    const float4 p = load_point(pts, static_cast<long long>(b) * n + i);
    const float x = p.x, y = p.y, z = p.z, valid = p.w;
    // comparisons with NaN are false, so NaN coordinates are dropped here
    const bool in_range = (x >= -16.0f) && (x <= 16.0f) && (y >= -24.0f) && (y <= 8.0f);
    if (!in_range || !(valid > 0.0f)) return;
    int ix = static_cast<int>(floorf((x + 16.0f) * 8.0f));
    int iy = static_cast<int>(floorf((y + 24.0f) * 8.0f));
    if (x == 16.0f) ix = kGrid - 1;
    if (y == 8.0f) iy = kGrid - 1;
    if (ix >= kGrid || iy >= kGrid) return;
    const int ch = (z <= -2.0f) ? 0 : 1;
    atomicAdd(counts + static_cast<long long>(b) * kCells + (ix * kGrid + iy) * 2 + ch, 1);
}

__global__ void bev_normalize_kernel(const int* __restrict__ counts, float* __restrict__ out,
                                     long long total) {
    const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (i >= total) return;
    out[i] = fminf(static_cast<float>(counts[i]), 5.0f) / 5.0f;
}

}  // namespace

// pts: (B, N, 4) contiguous, f16 if is_half else f32. counts: (B, 256, 256, 2)
// int32, zeroed by the caller. out: (B, 256, 256, 2) f32. Returns the CUDA
// error code of the launches (0 on success).
extern "C" int mmfn_bev_hist(const void* pts, int is_half, void* counts, void* out,
                             int batch, int n, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n > 0) {
        const dim3 grid((n + kThreads - 1) / kThreads, batch);
        if (is_half) {
            bev_count_kernel<__half><<<grid, kThreads, 0, s>>>(
                static_cast<const __half*>(pts), static_cast<int*>(counts), n);
        } else {
            bev_count_kernel<float><<<grid, kThreads, 0, s>>>(
                static_cast<const float*>(pts), static_cast<int*>(counts), n);
        }
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const long long total = static_cast<long long>(batch) * kCells;
    const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
    bev_normalize_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const int*>(counts),
                                                     static_cast<float*>(out), total);
    return static_cast<int>(cudaGetLastError());
}
