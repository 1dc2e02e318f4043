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
// above its few integer operations per point. At batch 1 only the cloud's
// cluster of SMs, not the whole card, moves those bytes.
//
// Design: the TPU kernel's int8 one-hot matmul is an MXU trick; on Hopper
// this is a scatter, and one cloud's int32 count grid (512 KiB) is more than
// one block's shared memory. So each cloud gets a thread-block cluster of C
// blocks (C = 8 or 16, a template parameter chosen per call), and block r
// holds ix rows [r 256/C, (r + 1) 256/C) of the cloud's count grid in its
// dynamic shared memory (64 KiB at C = 8, 32 KiB at C = 16): the cluster's
// distributed shared memory holds the whole grid, and no count ever goes to
// device memory. One launch per call, in five steps:
//   1. each block zeroes its band;
//   2. cluster.sync();
//   3. each block reads its 1/C of the cloud (one vector load per point, f16
//      or f32 as a template parameter, four points in flight per thread),
//      bins each point in f32 with the same expressions as the JAX kernel's
//      _bin_indices, and atomically adds 1 to the owning block's band
//      through distributed shared memory (cluster.map_shared_rank);
//   4. cluster.sync();
//   5. each block writes its band as min(count, 5) * 0.2f in f32, 16 bytes
//      a store. For the six counts 0..5 that product is the same f32 as
//      min(count, 5) / 5 (a test holds the two equal), without the cost of
//      an IEEE division in every cell.
// Integer atomics keep the counts exact and independent of order. C = 16
// halves the band each SM zeroes and writes, but is above the portable
// cluster size, so its launch allows it explicitly. The wrapper takes 16
// for one cloud and 8 for more, the faster size at batch 1 and at batch 8
// as chip_smoke.py times them. A point whose f32 sum (x + 16) or (y + 24)
// rounds up to 32 (the largest f32 below 16, the two below 8) lands in bin
// 256: this kernel drops it, as the JAX package's XLA path does (its Pallas
// kernel sends a below-split point with y-bin 256 to the above channel's
// y-bin 0). Any N is allowed, N = 0 and N below the cluster's thread count
// included: the grid then comes out zero.

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kGrid = 256;
constexpr int kThreads = 512;
constexpr int kUnroll = 4;   // points in flight per thread

// the band of one block in a cluster of C blocks per cloud
template <int C>
struct Band {
    static constexpr int kRows = kGrid / C;              // ix rows
    static constexpr int kCells = kRows * kGrid * 2;     // [ix][iy][channel] int32
    static constexpr int kBytes = kCells * static_cast<int>(sizeof(int));
};

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

// min(count, 5) / 5, exactly, for the counts 0..5 that can reach it
__device__ __forceinline__ float normalize(int count) {
    return fminf(static_cast<float>(count), 5.0f) * 0.2f;
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
bev_hist_kernel(const T* __restrict__ pts, float* __restrict__ out, int n) {
    constexpr int kBandRows = Band<C>::kRows, kBandCells = Band<C>::kCells;
    extern __shared__ int4 band4[];
    int* band = reinterpret_cast<int*>(band4);
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const long long b = blockIdx.y;

    // 1-2. zero this block's band; no block adds before all are zero
    for (int i = threadIdx.x; i < kBandCells / 4; i += kThreads) band4[i] = make_int4(0, 0, 0, 0);
    cluster.sync();

    // 3. bin this block's points into the owning bands
    const T* cloud = pts + b * n * 4;
    constexpr long long kStep = static_cast<long long>(C) * kThreads;
    for (long long base = static_cast<long long>(rank) * kThreads + threadIdx.x; base < n;
         base += kStep * kUnroll) {
        float4 p[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const long long i = base + u * kStep;
            p[u] = i < n ? load_point(cloud, i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const float x = p[u].x, y = p[u].y, z = p[u].z, valid = p[u].w;
            // comparisons with NaN are false, so NaN coordinates are dropped here
            const bool in_range = (x >= -16.0f) && (x <= 16.0f) && (y >= -24.0f) && (y <= 8.0f);
            if (!in_range || !(valid > 0.0f)) continue;
            int ix = static_cast<int>(floorf((x + 16.0f) * 8.0f));
            int iy = static_cast<int>(floorf((y + 24.0f) * 8.0f));
            if (x == 16.0f) ix = kGrid - 1;
            if (y == 8.0f) iy = kGrid - 1;
            if (ix >= kGrid || iy >= kGrid) continue;
            const int ch = (z <= -2.0f) ? 0 : 1;
            int* owner = cluster.map_shared_rank(band, ix / kBandRows);
            atomicAdd(owner + ((ix % kBandRows) * kGrid + iy) * 2 + ch, 1);
        }
    }

    // 4-5. once every add has landed, write this block's band
    cluster.sync();
    float4* dst = reinterpret_cast<float4*>(out + (b * kGrid + rank * kBandRows) * kGrid * 2);
    for (int i = threadIdx.x; i < kBandCells / 4; i += kThreads) {
        const int4 c = band4[i];
        dst[i] = make_float4(normalize(c.x), normalize(c.y), normalize(c.z), normalize(c.w));
    }
}

template <typename T, int C>
int launch(const T* pts, float* out, int batch, int n, cudaStream_t s) {
    const void* kernel = reinterpret_cast<const void*>(bev_hist_kernel<T, C>);
    static KernelAttribute smem_limit, non_portable;
    cudaError_t err = smem_limit.ensure(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        Band<C>::kBytes);
    if (err == cudaSuccess && C > 8)
        err = non_portable.ensure(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = C;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, batch);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = Band<C>::kBytes;
    cfg.stream = s;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
    const cudaError_t launched = cudaLaunchKernelEx(&cfg, bev_hist_kernel<T, C>, pts, out, n);
    const cudaError_t last = cudaGetLastError();   // also clears a refused launch
    return static_cast<int>(launched != cudaSuccess ? launched : last);
}

template <int C>
int launch_typed(const void* pts, int is_half, float* out, int batch, int n, cudaStream_t s) {
    if (is_half) return launch<__half, C>(static_cast<const __half*>(pts), out, batch, n, s);
    return launch<float, C>(static_cast<const float*>(pts), out, batch, n, s);
}

}  // namespace

// pts: (B, N, 4) contiguous, f16 if is_half else f32, 8- or 16-byte aligned.
// out: (B, 256, 256, 2) f32, 16-byte aligned, written whole. cluster: blocks
// per cloud, 8 or 16. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int mmfn_bev_hist(const void* pts, int is_half, void* out, int batch, int n,
                             int cluster, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* o = static_cast<float*>(out);
    switch (cluster) {
        case 8: return launch_typed<8>(pts, is_half, o, batch, n, s);
        case 16: return launch_typed<16>(pts, is_half, o, batch, n, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
