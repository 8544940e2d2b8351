// Causal / sliding-window GQA attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention_fwd
// (Pallas; grid (B, H, q blocks, kv blocks) with the kv-block axis sequential and
// the online-softmax state carried in VMEM scratch). The semantics are the TPU
// kernel's: f32 inside, masks with -1e30 (not -inf), causal means kpos <= qpos with
// both counted from 0, window > 0 adds kpos > qpos - window, and the output is
// acc / max(l, 1e-30) rounded once to q's type.
//
// What bounds it on this card: at the prefill shapes the serving path gives it
// (S = 576, hd = 128) it does ~2*S*hd/2 operations per K/V byte, far above the
// card's ratio of operations to bytes, so it is bound by operations. This first
// version runs them on the f32 SIMT pipes, not the tensor cores (mma/wgmma is a
// later step), so its ceiling is the card's 67 TFLOP/s of f32, not 989 of bf16.
// The design:
//   * one block of 128 threads per (q tile of 64 rows, q head, batch); KV head is
//     h / (H / KV), so a group's q heads read the same K/V (from L2);
//   * the block walks K/V tiles of 32 rows in order, as the TPU grid did, staging
//     Q once and each K/V tile through shared memory converted to f32;
//   * thread (ty, tx) = (tid / 16, tid % 16) owns q rows ty*8 .. ty*8+7: the
//     scores of columns tx and tx+16 of each tile, and output columns tx + 16*j;
//     row max and row sum reduce across the 16 lanes of a half warp by shuffles;
//   * running m, l and the output accumulator stay in f32 registers;
//   * tiles wholly above the causal diagonal or wholly outside the window are not
//     visited (the TPU kernel visits them and they contribute exactly zero);
//   * Sq and Sk need not be multiples of the tiles: rows past the end load as
//     zeros, are masked as keys and are not stored as queries;
//   * Q and K rows are padded by 4 floats in shared memory, so the float4 reads of
//     16 different K rows by one half warp fall in distinct banks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 32;        // k rows per tile
constexpr int kThreads = 128;  // 8 row groups x 16 lanes
constexpr int kRows = 8;       // q rows per thread
constexpr int kCols = kBK / 16;  // score columns per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load8(const float* __restrict__ p, float* v) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p, float* v) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
    }
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// rows [0, ROWS) of a (rows, HD) slab into f32 shared memory with row stride LD;
// rows at or past `valid` become zeros
template <typename T, int HD, int ROWS, int LD>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int valid) {
    constexpr int kChunks = HD / 8;
    for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
        const int r = i / kChunks;
        const int c = (i % kChunks) * 8;
        float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (r < valid) load8(src + static_cast<size_t>(r) * HD + c, v);
        float4* d = reinterpret_cast<float4*>(dst + r * LD + c);
        d[0] = make_float4(v[0], v[1], v[2], v[3]);
        d[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
}

template <int HD>
struct Smem {
    static constexpr int kLdQ = HD + 4;
    static constexpr int kLdK = HD + 4;
    static constexpr int kLdV = HD;
    static constexpr int kLdP = kBK + 4;
    static constexpr int kFloats = kBQ * kLdQ + kBK * kLdK + kBK * kLdV + kBQ * kLdP;
    static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int H, int KV, int Sq, int Sk, int causal, int window, float scale) {
    using L = Smem<HD>;
    constexpr int kOut = HD / 16;  // output columns per thread
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);
    float* Ks = Qs + kBQ * L::kLdQ;
    float* Vs = Ks + kBK * L::kLdK;
    float* Ps = Vs + kBK * L::kLdV;

    const int q0 = blockIdx.x * kBQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int kvh = h / (H / KV);
    const int tid = threadIdx.x;
    const int ty = tid / 16;
    const int tx = tid % 16;

    const T* qb = q + (static_cast<size_t>(b) * H + h) * Sq * HD;
    const T* kb = k + (static_cast<size_t>(b) * KV + kvh) * Sk * HD;
    const T* vb = v + (static_cast<size_t>(b) * KV + kvh) * Sk * HD;
    T* ob = o + (static_cast<size_t>(b) * H + h) * Sq * HD;

    const int q_valid = min(kBQ, Sq - q0);
    stage<T, HD, kBQ, L::kLdQ>(Qs, qb + static_cast<size_t>(q0) * HD, q_valid);

    // K/V tiles this q tile can see: [t_lo, t_hi)
    const int qmin = q0;
    const int qmax = q0 + q_valid - 1;
    const int n_tiles = (Sk + kBK - 1) / kBK;
    int t_hi = n_tiles;
    if (causal) t_hi = min(n_tiles, qmax / kBK + 1);
    int t_lo = 0;
    if (window > 0) {
        const int first_live = qmin - window + 1;  // smallest kpos any row keeps
        if (first_live > 0) t_lo = first_live / kBK;
    }

    float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        m[i] = kNegInf;
        l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < kOut; ++j) acc[i][j] = 0.f;
    }

    for (int t = t_lo; t < t_hi; ++t) {
        const int k0 = t * kBK;
        __syncthreads();  // previous tile's P and V reads are done
        const int k_valid = min(kBK, Sk - k0);
        stage<T, HD, kBK, L::kLdK>(Ks, kb + static_cast<size_t>(k0) * HD, k_valid);
        stage<T, HD, kBK, L::kLdV>(Vs, vb + static_cast<size_t>(k0) * HD, k_valid);
        __syncthreads();

        // scores s[i][j] of row ty*8+i against key column tx + 16*j
        float s[kRows][kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < HD; d += 4) {
            float4 kv4[kCols];
#pragma unroll
            for (int j = 0; j < kCols; ++j)
                kv4[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * L::kLdK + d);
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
                const float4 qv = *reinterpret_cast<const float4*>(Qs + (ty * kRows + i) * L::kLdQ + d);
#pragma unroll
                for (int j = 0; j < kCols; ++j) {
                    s[i][j] = fmaf(qv.x, kv4[j].x, s[i][j]);
                    s[i][j] = fmaf(qv.y, kv4[j].y, s[i][j]);
                    s[i][j] = fmaf(qv.z, kv4[j].z, s[i][j]);
                    s[i][j] = fmaf(qv.w, kv4[j].w, s[i][j]);
                }
            }
        }

        // mask, online softmax, P to shared memory
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            const int qpos = q0 + ty * kRows + i;
            float rmax = kNegInf;
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
                const int kpos = k0 + tx + 16 * j;
                bool ok = kpos < Sk;
                if (causal) ok = ok && kpos <= qpos;
                if (window > 0) ok = ok && kpos > qpos - window;
                s[i][j] = ok ? s[i][j] * scale : kNegInf;
                rmax = fmaxf(rmax, s[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
            const float m_new = fmaxf(m[i], rmax);
            float rsum = 0.f;
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
                const float p = expf(s[i][j] - m_new);
                rsum += p;
                Ps[(ty * kRows + i) * L::kLdP + tx + 16 * j] = p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
            const float alpha = expf(m[i] - m_new);
            l[i] = l[i] * alpha + rsum;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < kOut; ++j) acc[i][j] *= alpha;
        }
        __syncthreads();

        // acc[i][j] += sum_k P[row i][k] * V[k][tx + 16*j]
#pragma unroll 2
        for (int kk = 0; kk < kBK; kk += 4) {
            float vv[4][kOut];
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int j = 0; j < kOut; ++j) vv[u][j] = Vs[(kk + u) * L::kLdV + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
                const float4 p = *reinterpret_cast<const float4*>(Ps + (ty * kRows + i) * L::kLdP + kk);
#pragma unroll
                for (int j = 0; j < kOut; ++j) {
                    acc[i][j] = fmaf(p.x, vv[0][j], acc[i][j]);
                    acc[i][j] = fmaf(p.y, vv[1][j], acc[i][j]);
                    acc[i][j] = fmaf(p.z, vv[2][j], acc[i][j]);
                    acc[i][j] = fmaf(p.w, vv[3][j], acc[i][j]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int r = ty * kRows + i;
        if (r >= q_valid) continue;
        const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int j = 0; j < kOut; ++j)
            store1(ob + static_cast<size_t>(q0 + r) * HD + tx + 16 * j, acc[i][j] * inv);
    }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                   int KV, int Sq, int Sk, int causal, int window, float scale,
                   cudaStream_t stream) {
    constexpr size_t bytes = Smem<HD>::kBytes;
    // above 48 KiB of dynamic shared memory a kernel must opt in, once per process;
    // every call sets it again: the call is cheap next to the kernel and has no race
    cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
    flash_attention_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), H, KV, Sq, Sk, causal, window, scale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o, int B, int H,
                      int KV, int Sq, int Sk, int hd, int causal, int window, float scale,
                      cudaStream_t stream) {
    switch (hd) {
        case 32: return launch<T, 32>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, scale, stream);
        case 64: return launch<T, 64>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, scale, stream);
        case 128: return launch<T, 128>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, scale, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// q (B,H,Sq,hd), k/v (B,KV,Sk,hd), o (B,H,Sq,hd), all contiguous and 16-byte aligned.
// dtype: 0 = float32, 2 = bfloat16. hd in {32, 64, 128}; H a multiple of KV.
// Returns the cudaError_t of the launch (0 = cudaSuccess); cudaErrorInvalidValue for
// an unsupported dtype or hd.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int H, int KV, int Sq, int Sk, int hd,
                                      int dtype, int causal, int window, float scale,
                                      void* stream) {
    if (B <= 0 || H <= 0 || Sq <= 0) return cudaSuccess;
    if (KV <= 0 || H % KV != 0 || Sk < 0) return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return static_cast<int>(
            launch_hd<float>(q, k, v, o, B, H, KV, Sq, Sk, hd, causal, window, scale, st));
        case 2: return static_cast<int>(
            launch_hd<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Sk, hd, causal, window, scale, st));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
