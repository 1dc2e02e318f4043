// Fused inference self-attention for Hopper (sm_90a): softmax(q k^T * scale) v
// over (B, H, T, D) f32 tensors, no mask, no dropout, no backward.
//
// Replaces: mmfn_tpu/ops/attention.py:_attn_kernel (launched by
// _fused_attention / fused_attention), which MMFN's fusion transformers call
// when attn_impl == "pallas" and not training.
//
// What bounds it on the H100: at rad stage 4 (B=1, H=4, T=256, D=128) it
// does 4*B*H*T*T*D = 134 MFLOP on 2 MiB of q, k, v and o. At the 165 TFLOP/s
// that three TF32 tensor-core products per f32 product allow (495 / 3) that
// is 0.81 us, against 0.63 us of memory traffic at 3.35 TB/s: operations,
// narrowly. (On the CUDA cores at 67 TFLOP/s it would be 2.0 us.) At the
// main-path sizes a block has little work and a warp has its scheduler to
// itself, so the time goes to instruction issue and latency: the design
// keeps the instructions per product few and their chains independent.
//
// Design:
// - Operands in place. q, k, v are read where the projections leave them:
//   (b, h, t) element strides are arguments and only the last dimension must
//   be contiguous, so the view(b, t, h, d).transpose(1, 2) heads of a Linear's
//   output need no copy. o is a contiguous (B, T, H, D) buffer, so the
//   caller's reshape back to (B, T, H*D) is free.
// - Grid (ceil(T / 16), H, B): one block per 16 query rows of one (b, h),
//   4 warps. The warps split the keys: warp w takes the 8-key tiles
//   w, w + 4, w + 8, ... and keeps its own running row max and sum (online
//   softmax) and its own 16 x D partial O in registers. At the end the
//   warps combine max, sum and O through shared memory. The (T, T) matrix
//   never leaves registers, and no buffer grows with T (the wrapper takes
//   T up to 3072, the largest checked on the card). At batch 1, T = 256 the
//   grid is 64 blocks.
// - Tensor cores at f32 accuracy ("3xTF32", as CUTLASS's
//   OpMultiplyAddFastF32): both products use mma.sync m16n8k8 TF32 with f32
//   accumulators. Every f32 operand x splits into big = cvt.rna.tf32(x) and
//   small = cvt.rna.tf32(x - big), and each product accumulates
//   small*big + big*small + big*big. What is dropped, small*small, is about
//   2^-22 of the product, so results stay within 1e-5 of the f32 plain
//   version. One TF32 product alone would move them by about 1e-3. Q is
//   split once into shared memory; K, V and P are split as they are used.
//   In S = Q K^T the three terms go to three accumulators, summed after
//   the D/8 steps, so that the products of one step do not wait on each
//   other; in P V the D/8 output tiles are already independent.
// - Fragment layouts. For TF32 the m16n8 accumulator of S (a lane holds
//   row g, keys 2c and 2c+1, and row g+8 likewise; g = lane / 4,
//   c = lane % 4) is not the m16n8k8 A layout that P V needs (row g, k = c
//   and k = c + 4). Rather than move P with __shfl_sync or through shared
//   memory, the P V product numbers the 8 keys of a tile in another order:
//   k = c stands for key 2c and k = c + 4 for key 2c + 1. A sum over keys
//   does not depend on their order, so the S accumulator registers are P's
//   A fragment as they are, and the V fragment is read from rows 2c and
//   2c + 1 to match.
// - Copies overlap work. Each warp streams its K and V tiles with 16-byte
//   cp.async.cg into its own ring of 2 (D = 128) or 3 shared-memory stages,
//   so the next tiles load while the current one multiplies, and only
//   __syncwarp orders the ring. 8-key tiles keep a block at D = 128 under
//   84 KB, so two blocks share an SM at batch 8. Rows of the ring and of Q
//   are padded to D + 4 floats, which makes every fragment load free of
//   bank conflicts: K and Q are read at (row g, column c), V at
//   (row 2c, column g). Ragged T: past-the-end keys are zero-filled by the
//   copy and scored -inf; past-the-end query rows are zero and not stored.
// - expf is the accurate one (no fast-math). The shared-memory limit is set
//   once per template instance and device, not per launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kRows = 16;                 // query rows per block: one m16 tile
constexpr int kWarps = 4;                 // warps per block, splitting the keys
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 8;                  // keys per warp tile: one n8 tile of S

struct Params {
    const float* q;
    const float* k;
    const float* v;
    float* o;
    long long q_sb, q_sh, q_st;   // element strides of b, h, t
    long long k_sb, k_sh, k_st;
    long long v_sb, v_sh, v_st;
    int t;
    float scale;
};

template <int D>
struct Layout {
    static constexpr int kStride = D + 4;                    // padded row, in floats
    static constexpr int kStages = D <= 64 ? 3 : 2;          // ring depth per warp
    static constexpr int kTile = kKeys * kStride;            // one K or V tile
    static constexpr int kRing = kStages * 2 * kTile;        // one warp's ring: K, V per stage
    static constexpr int kQ = kRows * kStride;               // Q big or Q small
    // Q big, Q small, 4 rings, then per warp and row: max, sum, combine scale; per row: sum
    static constexpr int kFloats = 2 * kQ + kWarps * kRing + 3 * kWarps * kRows + kRows;
    static constexpr int kBytes = kFloats * static_cast<int>(sizeof(float));
    static_assert(D % 16 == 0 && (kKeys * D / 4) % 32 == 0 && kRing >= kRows * kStride,
                  "unsupported head dim");
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

// x = big + small + (about 2^-22 x), both halves TF32
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
    big = to_tf32(x);
    small = to_tf32(x - __uint_as_float(big));
}

// c += a b on the tensor cores, one TF32 product
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(valid ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int D>
__global__ void __launch_bounds__(kThreads) attention_kernel(const Params p) {
    using L = Layout<D>;
    constexpr int S = L::kStride;
    constexpr int kVec = D / 4;   // float4 per row
    extern __shared__ __align__(16) float smem[];
    uint32_t* q_big = reinterpret_cast<uint32_t*>(smem);
    uint32_t* q_small = q_big + L::kQ;
    float* rings = smem + 2 * L::kQ;
    float* stat_max = rings + kWarps * L::kRing;     // [warp][row]
    float* stat_sum = stat_max + kWarps * kRows;     // [warp][row]
    float* comb_scale = stat_sum + kWarps * kRows;   // [warp][row]
    float* row_sum = comb_scale + kWarps * kRows;    // [row]

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const int t = p.t;
    const int row0 = blockIdx.x * kRows;
    const long long h = blockIdx.y, b = blockIdx.z, o_st = gridDim.y * D;   // o: (B, T, H, D)
    const float* qb = p.q + b * p.q_sb + h * p.q_sh;
    const float* kb = p.k + b * p.k_sb + h * p.k_sh;
    const float* vb = p.v + b * p.v_sb + h * p.v_sh;
    float* ob = p.o + b * t * o_st + h * D;

    float* ring = rings + warp * L::kRing;
    const int n_tiles = (t + kKeys - 1) / kKeys;
    const int my_tiles = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps : 0;

    // the warp's i-th tile, keys [(i * kWarps + warp) * kKeys, +kKeys), into stage i % kStages
    const long long k_st = p.k_st, v_st = p.v_st;
    auto load_tile = [=](int i) {
        const int key0 = (i * kWarps + warp) * kKeys;
        float* ks = ring + (i % L::kStages) * 2 * L::kTile;
        float* vs = ks + L::kTile;
#pragma unroll
        for (int it = 0; it < kKeys * kVec / 32; ++it) {
            const int j = it * 32 + lane;
            const int r = j / kVec, col = (j % kVec) * 4;
            const bool ok = key0 + r < t;
            const long long row = ok ? key0 + r : 0;
            cp_async16(ks + r * S + col, kb + row * k_st + col, ok);
            cp_async16(vs + r * S + col, vb + row * v_st + col, ok);
        }
    };

    // the first stages load while Q is split
#pragma unroll
    for (int i = 0; i < L::kStages - 1; ++i) {
        if (i < my_tiles) load_tile(i);
        cp_async_commit();
    }
    for (int j = tid; j < kRows * kVec; j += kThreads) {
        const int r = j / kVec, col = (j % kVec) * 4;
        float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (row0 + r < t) x = *reinterpret_cast<const float4*>(qb + (row0 + r) * p.q_st + col);
        uint32_t* big = q_big + r * S + col;
        uint32_t* small = q_small + r * S + col;
        split(x.x, big[0], small[0]);
        split(x.y, big[1], small[1]);
        split(x.z, big[2], small[2]);
        split(x.w, big[3], small[3]);
    }
    __syncthreads();

    float o[D / 8][4];   // partial O: n8 tile dn holds rows g, g+8 and columns dn*8 + 2c, +1
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.0f;
    float m_run[2] = {-INFINITY, -INFINITY};   // rows g, g + 8
    float l_run[2] = {0.0f, 0.0f};             // this lane's share of the row sums

    for (int i = 0; i < my_tiles; ++i) {
        if (i + L::kStages - 1 < my_tiles) load_tile(i + L::kStages - 1);
        cp_async_commit();
        cp_async_wait<L::kStages - 1>();   // tile i has landed
        __syncwarp();
        const float* ks = ring + (i % L::kStages) * 2 * L::kTile;
        const float* vs = ks + L::kTile;
        const int key0 = (i * kWarps + warp) * kKeys;

        // S = Q K^T for 16 rows x 8 keys: s holds rows g, g+8 and keys 2c, 2c+1;
        // the three 3xTF32 terms accumulate apart
        float s[4] = {}, s_sb[4] = {}, s_bs[4] = {};
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
            const int col = kk * 8 + c;
            const uint32_t a_big[4] = {q_big[g * S + col], q_big[(g + 8) * S + col],
                                       q_big[g * S + col + 4], q_big[(g + 8) * S + col + 4]};
            const uint32_t a_small[4] = {q_small[g * S + col], q_small[(g + 8) * S + col],
                                         q_small[g * S + col + 4],
                                         q_small[(g + 8) * S + col + 4]};
            const float* kr = ks + g * S + col;   // B(k, n) = K[key n][d k]
            uint32_t b_big[2], b_small[2];
            split(kr[0], b_big[0], b_small[0]);
            split(kr[4], b_big[1], b_small[1]);
            mma_tf32(s_sb, a_small, b_big);
            mma_tf32(s_bs, a_big, b_small);
            mma_tf32(s, a_big, b_big);
        }

        // online softmax: scale, mask past-the-end keys, new row max, rescale
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int key = key0 + 2 * c + (e & 1);
            s[e] = key < t ? (s[e] + (s_sb[e] + s_bs[e])) * p.scale : -INFINITY;
            mx[e / 2] = fmaxf(mx[e / 2], s[e]);
        }
        float alpha[2], part[2] = {0.0f, 0.0f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m_run[r], mx[r]);   // finite: key0 < t
            alpha[r] = expf(m_run[r] - m_new);
            m_run[r] = m_new;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            s[e] = expf(s[e] - m_run[e / 2]);
            part[e / 2] += s[e];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + part[r];

        // O += P V, one k8 step: k = c stands for key 2c and k = c + 4 for
        // key 2c + 1, so s is P's A fragment as it is
        uint32_t p_big[4], p_small[4];
        split(s[0], p_big[0], p_small[0]);   // row g,     k = c
        split(s[2], p_big[1], p_small[1]);   // row g + 8, k = c
        split(s[1], p_big[2], p_small[2]);   // row g,     k = c + 4
        split(s[3], p_big[3], p_small[3]);   // row g + 8, k = c + 4
        const float* vr = vs + 2 * c * S + g;   // B(k, n) = V[key(k)][d n]
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
            o[dn][0] *= alpha[0];
            o[dn][1] *= alpha[0];
            o[dn][2] *= alpha[1];
            o[dn][3] *= alpha[1];
            uint32_t b_big[2], b_small[2];
            split(vr[dn * 8], b_big[0], b_small[0]);       // key 2c
            split(vr[S + dn * 8], b_big[1], b_small[1]);   // key 2c + 1
            mma_tf32(o[dn], p_small, b_big);
            mma_tf32(o[dn], p_big, b_small);
            mma_tf32(o[dn], p_big, b_big);
        }
        __syncwarp();   // the stage is refilled in a later iteration
    }
    cp_async_wait<0>();   // only empty groups remain; the ring is reused below
    __syncwarp();

    // combine the warps: each writes its max, sum and unnormalised O
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
    if (c == 0) {
        stat_max[warp * kRows + g] = m_run[0];
        stat_max[warp * kRows + g + 8] = m_run[1];
        stat_sum[warp * kRows + g] = l_run[0];
        stat_sum[warp * kRows + g + 8] = l_run[1];
    }
    float* part_o = ring;   // [kRows][S], in this warp's own ring
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
        *reinterpret_cast<float2*>(part_o + g * S + dn * 8 + 2 * c) =
            make_float2(o[dn][0], o[dn][1]);
        *reinterpret_cast<float2*>(part_o + (g + 8) * S + dn * 8 + 2 * c) =
            make_float2(o[dn][2], o[dn][3]);
    }
    __syncthreads();
    if (tid < kRows) {
        // a warp with no keys has max -inf and weight 0; warp 0 always has keys
        float m = -INFINITY;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) m = fmaxf(m, stat_max[w * kRows + tid]);
        float l = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            const float sc = expf(stat_max[w * kRows + tid] - m);
            comb_scale[w * kRows + tid] = sc;
            l += sc * stat_sum[w * kRows + tid];
        }
        row_sum[tid] = l;
    }
    __syncthreads();
    for (int j = tid; j < kRows * kVec; j += kThreads) {
        const int r = j / kVec, col = (j % kVec) * 4;
        if (row0 + r >= t) continue;
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            const float sc = comb_scale[w * kRows + r];
            const float4 x = *reinterpret_cast<const float4*>(rings + w * L::kRing + r * S + col);
            acc.x = fmaf(sc, x.x, acc.x);
            acc.y = fmaf(sc, x.y, acc.y);
            acc.z = fmaf(sc, x.z, acc.z);
            acc.w = fmaf(sc, x.w, acc.w);
        }
        const float l = row_sum[r];
        *reinterpret_cast<float4*>(ob + (row0 + r) * o_st + col) =
            make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l);
    }
}

template <int D>
int launch(const Params& p, int b, int h, cudaStream_t s) {
    static KernelAttribute smem_limit;
    const cudaError_t err =
        smem_limit.ensure(reinterpret_cast<const void*>(attention_kernel<D>),
                          cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<D>::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((p.t + kRows - 1) / kRows, h, b);
    attention_kernel<D><<<grid, kThreads, Layout<D>::kBytes, s>>>(p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: (b, h, t, d) f32 views whose last dimension is contiguous, with
// element strides q_s = {b, h, t} (likewise k_s, v_s), every base and
// stride 16-byte aligned; o: a contiguous (b, t, h, d) buffer, 16-byte
// aligned. d in {16, 32, 64, 128}, 1 <= t, b and h <= 65535. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int mmfn_attention_f32(const void* q, const void* k, const void* v, void* o,
                                  const long long* q_s, const long long* k_s,
                                  const long long* v_s, int b, int h, int t, int d,
                                  float scale, void* stream) {
    const Params p{static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v), static_cast<float*>(o),
                   q_s[0], q_s[1], q_s[2], k_s[0], k_s[1], k_s[2],
                   v_s[0], v_s[1], v_s[2], t, scale};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (d) {
        case 16: return launch<16>(p, b, h, s);
        case 32: return launch<32>(p, b, h, s);
        case 64: return launch<64>(p, b, h, s);
        case 128: return launch<128>(p, b, h, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
