// Fused inference self-attention for Hopper (sm_90a): softmax(q k^T * scale) v
// over (B, H, T, D) f32 tensors, no mask, no dropout, no backward.
//
// Replaces: mmfn_tpu/ops/attention.py:_attn_kernel (launched by
// _fused_attention / fused_attention), which MMFN's fusion transformers call
// when attn_impl == "pallas" and not training.
//
// What bounds it on the H100: operations. At rad stage 4 (B=1, H=4, T=256,
// D=128) it does 4*B*H*T*T*D = 134 MFLOP on 2 MiB of q, k, v and o: about
// 2 us at the 67 TFLOP/s f32 rate of the CUDA cores against 0.6 us of
// memory traffic.
//
// Design: the Pallas kernel keeps the whole (T, D) tile set of one (b, h) in
// VMEM. That does not carry over: at T=256, D=128 in f32, K and V alone take
// 2 x 128 KiB, more than the 227 KB of shared memory a block may use; and a
// grid of B*H = 4 blocks at batch 1 would leave 128 of the 132 SMs idle. So
// the grid is (ceil(T / 16), B*H): each block owns a 16-row query tile and a
// 16 x T score strip in shared memory (16 KiB at T=256), and streams K, then
// V, through shared memory in 32-row tiles, in two passes:
//   1. scores S = (Q K^T) * scale into the strip;
//   2. per row: max, exp(s - max) in place, row sum (one warp per row);
//   3. O = (P V) / rowsum, each thread holding D/16 outputs in registers.
// Everything is f32 on the CUDA cores with fmaf and the accurate expf (no
// fast-math), so the kernel stays within 1e-5 of the plain PyTorch version.
// K/V tiles are padded to D+1 columns so the score loop reads shared memory
// without bank conflicts. Tensor cores (wgmma), TMA and tuning come later.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kRows = 16;     // query rows per block
constexpr int kKeys = 32;     // keys per staged K/V tile
constexpr int kThreads = 256;  // 8 warps

template <int D>
__device__ __forceinline__ void load_tile(float (*dst)[D + 1], const float* __restrict__ src,
                                          int row0, int t) {
    for (int i = threadIdx.x; i < kKeys * D; i += kThreads) {
        const int r = i / D, d = i % D;
        dst[r][d] = (row0 + r < t) ? src[static_cast<long long>(row0 + r) * D + d] : 0.0f;
    }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int t, float scale) {
    static_assert(kThreads % D == 0 && (kRows * D) % kThreads == 0, "unsupported head dim");
    __shared__ float sq[kRows][D];
    __shared__ float skv[kKeys][D + 1];
    __shared__ float srow_sum[kRows];
    extern __shared__ float ss[];  // [kRows][t] score strip

    const long long base = static_cast<long long>(blockIdx.y) * t * D;
    const float* qb = q + base;
    const float* kb = k + base;
    const float* vb = v + base;
    float* ob = o + base;
    const int row0 = blockIdx.x * kRows;
    const int tid = threadIdx.x;

    for (int i = tid; i < kRows * D; i += kThreads) {
        const int r = i / D, d = i % D;
        sq[r][d] = (row0 + r < t) ? qb[static_cast<long long>(row0 + r) * D + d] : 0.0f;
    }

    // 1. scores
    for (int j0 = 0; j0 < t; j0 += kKeys) {
        __syncthreads();
        load_tile<D>(skv, kb, j0, t);
        __syncthreads();
        for (int p = tid; p < kRows * kKeys; p += kThreads) {
            const int r = p / kKeys, c = p % kKeys;
            float acc = 0.0f;
#pragma unroll
            for (int d = 0; d < D; ++d) acc = fmaf(sq[r][d], skv[c][d], acc);
            if (j0 + c < t) ss[r * t + j0 + c] = acc * scale;
        }
    }
    __syncthreads();

    // 2. row softmax numerators and sums, one warp per row
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < kRows; r += kThreads / 32) {
        float* row = ss + r * t;
        float m = -INFINITY;
        for (int j = lane; j < t; j += 32) m = fmaxf(m, row[j]);
        for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        float l = 0.0f;
        for (int j = lane; j < t; j += 32) {
            const float e = expf(row[j] - m);
            row[j] = e;
            l += e;
        }
        for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
        if (lane == 0) srow_sum[r] = l;
    }

    // 3. O = P V / rowsum
    constexpr int kRowsPerPass = kThreads / D;
    constexpr int kPasses = kRows / kRowsPerPass;
    const int d = tid % D, rsub = tid / D;
    float acc[kPasses];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) acc[p] = 0.0f;
    for (int j0 = 0; j0 < t; j0 += kKeys) {
        __syncthreads();
        load_tile<D>(skv, vb, j0, t);
        __syncthreads();
        const int jn = min(kKeys, t - j0);
        for (int c = 0; c < jn; ++c) {
            const float vv = skv[c][d];
#pragma unroll
            for (int p = 0; p < kPasses; ++p)
                acc[p] = fmaf(ss[(rsub + p * kRowsPerPass) * t + j0 + c], vv, acc[p]);
        }
    }
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
        const int r = rsub + p * kRowsPerPass;
        if (row0 + r < t) ob[static_cast<long long>(row0 + r) * D + d] = acc[p] / srow_sum[r];
    }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, int bh, int t, float scale,
           cudaStream_t s) {
    const size_t strip = static_cast<size_t>(kRows) * t * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(attention_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(strip));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((t + kRows - 1) / kRows, bh);
    attention_kernel<D><<<grid, kThreads, strip, s>>>(q, k, v, o, t, scale);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: (bh, t, d) contiguous f32 with d in {16, 32, 64, 128}.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int mmfn_attention_f32(const void* q, const void* k, const void* v, void* o, int bh,
                                  int t, int d, float scale, void* stream) {
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    float* of = static_cast<float*>(o);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (d) {
        case 16: return launch<16>(qf, kf, vf, of, bh, t, scale, s);
        case 32: return launch<32>(qf, kf, vf, of, bh, t, scale, s);
        case 64: return launch<64>(qf, kf, vf, of, bh, t, scale, s);
        case 128: return launch<128>(qf, kf, vf, of, bh, t, scale, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
