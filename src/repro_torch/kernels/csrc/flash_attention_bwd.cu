// Causal / sliding-window GQA attention, backward, for Hopper (sm_90a).
//
// The TPU kernel src/repro/kernels/flash_attention.py:flash_attention_fwd has no
// backward: the JAX train step differentiates its own attention through XLA
// (jax.value_and_grad over models/attention.py:gqa_attention). The port trains
// through its forward kernel (flash_attention.cu), so the gradient of that
// kernel's function is a kernel too. The semantics are the forward's: scores
// scale·q·kᵀ in f32, causal keeps kpos <= qpos, window > 0 adds kpos > qpos -
// window, q head h reads KV head h / (H / KV); here Sq = Sk = S.
//
// The FlashAttention-2 backward. With the forward's per-row log-sum-exp (lse,
// natural log, f32) and D = rowsum(dO ∘ O):
//   P  = exp(scale·Q Kᵀ − lse)   (0 where masked)
//   dV = Pᵀ dO        dP = dO Vᵀ        dS = P ∘ (dP − D)
//   dK = scale · dSᵀ Q               dQ = scale · dS K
// Two kernels, one after the other on the caller's stream, and no atomics, so
// two calls give bit-equal gradients:
//   * dq_kernel: one CTA per (q tile, q head, batch). It computes D for its rows
//     (and writes it for the next kernel), then walks the K/V tiles its rows can
//     see, rebuilding S, P, dP and dS, and accumulates dQ in registers; the
//     heaviest causal q tiles start first;
//   * dkdv_kernel: one CTA per (K/V tile, KV head, batch). It keeps its K and V
//     tile in shared memory and walks the q heads of its GQA group and, for each,
//     the q tiles that can see the tile (causal: from the diagonal on; window: up
//     to the last key + window − 1), accumulating dK and dV in registers. So a
//     group's q heads are summed by one CTA, in a fixed order.
// Everything is accumulated in f32 and written once in the inputs' dtype.
//
// What bounds it: with S² / 2 live pairs a head it does seven products of the
// forward's size (Q·Kᵀ and dO·Vᵀ in both kernels, Pᵀ·dO, dSᵀ·Q, dS·K), so it is
// bound by operations at every training shape. flash_attention_bwd_launch
// dispatches by dtype to one of two pairs of kernels.
//
// bfloat16: tc::, on the tensor cores through mma.sync.m16n8k16 (bf16 in, f32
// accumulators in registers), FlashAttention-2's warp layout:
//   * 128 threads, 4 warps; a warp owns 16 rows of the CTA's tile (16 keys in the
//     dK/dV kernel, 16 q rows in the dQ kernel) and 16 × hd f32 accumulators of
//     its gradient;
//   * tiles are staged in bf16 in shared memory, rows padded by 16 bytes so that
//     the eight 16-byte rows of an ldmatrix fall in distinct banks; operands reach
//     the tensor cores by ldmatrix (.trans where the product's k axis is the
//     tile's row axis: Pᵀ·dO, dSᵀ·Q, dS·K);
//   * Sᵀ / S and dPᵀ / dP come out in the accumulator layout; P and dS are formed
//     there in f32 and rounded to bf16 in place as the A operand of the next
//     product (two adjacent n8 accumulator tiles are one k16 A fragment), so P
//     never leaves registers. P rounds as the forward's P·V product rounds it;
//     dS rounds once (about 2^-9 relative), inside the bf16 tolerance of 2e-2;
//   * dK/dV kernel: 64 keys a CTA, q tiles of 32 rows; dQ kernel: 64 q rows a CTA,
//     K/V tiles of 64 keys. Shared memory at hd 128: 52 KB and 70 KB.
// Tiles are loaded by the CTA's threads with 16-byte loads between barriers, not
// yet by TMA into a ring, and the products are mma.sync, not wgmma: the next
// steps (ROADMAP.md, kernel item K2).
//
// float32: simt::, on the f32 SIMT pipes (67 TFLOP/s; on the tensor cores f32 would
// be TF32 and miss the f32 tolerance). Its design:
//   * 128 threads as 8 row groups (ty) × 16 lanes (tx). For the scores a thread
//     owns 4 q rows × (kBK / 16) keys (tx + 16 j); for dK/dV it owns kBK / 8 key
//     rows × hd / 16 columns (tx + 16 c), for dQ 4 q rows × hd / 16 columns;
//     row sums reduce across the 16 lanes of a half warp by shuffles;
//   * tiles are staged in shared memory; K and V rows are padded by 4 floats so
//     that the float4 reads of 16 different rows by a half warp fall in distinct
//     banks; Q and dO rows are read by one row group at a time (a broadcast) and
//     need no padding;
//   * tiles: kBQ = 32 q rows; kBK = 32 keys at hd 128 (dK + dV: 64 f32 registers a
//     thread), 64 at hd 32 and 64. Shared memory: 76 KB at hd 128, two CTAs an SM.
// Both: rows past S are staged as zeros and masked, so S need not be a multiple
// of a tile. hd 256 is not instantiated (ROADMAP.md, kernel item K2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // both pairs of kernels

__device__ __forceinline__ bool live(int qpos, int kpos, int S, int causal, int window) {
    bool ok = qpos < S && kpos < S;
    if (causal) ok = ok && kpos <= qpos;
    if (window > 0) ok = ok && kpos > qpos - window;
    return ok;
}

namespace simt {

constexpr int kBQ = 32;        // q rows per tile
constexpr int kRQ = kBQ / 8;   // q rows per thread

template <int HD>
struct Cfg {
    static constexpr int kBK = HD >= 128 ? 32 : 64;  // keys per tile
    static constexpr int kCK = kBK / 16;             // score columns per thread
    static constexpr int kRK = kBK / 8;              // dK/dV rows per thread
    static constexpr int kCols = HD / 16;            // output columns per thread
    static constexpr int kLdK = HD + 4;              // K and V rows in shared memory
    static constexpr int kLdP = kBK + 4;             // P and dS rows
    // K | V | Q | dO | P | dS | lse | D (dq_kernel leaves P out)
    static constexpr int kOffV = kBK * kLdK;
    static constexpr int kOffQ = 2 * kBK * kLdK;
    static constexpr int kOffO = kOffQ + kBQ * HD;
    static constexpr int kOffP = kOffO + kBQ * HD;
    static constexpr int kOffS = kOffP + kBQ * kLdP;
    static constexpr int kOffL = kOffS + kBQ * kLdP;
    static constexpr int kOffD = kOffL + kBQ;
    static constexpr size_t kBytes = sizeof(float) * (kOffD + kBQ);
};

__device__ __forceinline__ void load8(const float* __restrict__ p, float* v) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// rows [0, ROWS) of a (rows, HD) slab into f32 shared memory with row stride LD;
// rows at or past `valid` become zeros
template <int HD, int ROWS, int LD>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int valid) {
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

// For the q tile at q0 (Q, dO, lse and D staged) and the K/V tile at k0 (staged):
// P into sP when WANT_P, and dS into sS.
// Thread (ty, tx) owns q rows ty*kRQ + i and keys tx + 16 j.
template <int HD, bool WANT_P>
__device__ __forceinline__ void scores(const float* sK, const float* sV, const float* sQ,
                                       const float* sO, const float* sL, const float* sD,
                                       float* sP, float* sS, int q0, int k0, int S,
                                       int causal, int window, float scale) {
    using C = Cfg<HD>;
    const int ty = threadIdx.x / 16;
    const int tx = threadIdx.x % 16;
    float s[kRQ][C::kCK], dp[kRQ][C::kCK];
#pragma unroll
    for (int i = 0; i < kRQ; ++i)
#pragma unroll
        for (int j = 0; j < C::kCK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
        float4 kk[C::kCK], vv[C::kCK];
#pragma unroll
        for (int j = 0; j < C::kCK; ++j) {
            kk[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * C::kLdK + d);
            vv[j] = *reinterpret_cast<const float4*>(sV + (tx + 16 * j) * C::kLdK + d);
        }
#pragma unroll
        for (int i = 0; i < kRQ; ++i) {
            const float4 qv = *reinterpret_cast<const float4*>(sQ + (ty * kRQ + i) * HD + d);
            const float4 ov = *reinterpret_cast<const float4*>(sO + (ty * kRQ + i) * HD + d);
#pragma unroll
            for (int j = 0; j < C::kCK; ++j) {
                s[i][j] = fmaf(qv.x, kk[j].x, s[i][j]);
                s[i][j] = fmaf(qv.y, kk[j].y, s[i][j]);
                s[i][j] = fmaf(qv.z, kk[j].z, s[i][j]);
                s[i][j] = fmaf(qv.w, kk[j].w, s[i][j]);
                dp[i][j] = fmaf(ov.x, vv[j].x, dp[i][j]);
                dp[i][j] = fmaf(ov.y, vv[j].y, dp[i][j]);
                dp[i][j] = fmaf(ov.z, vv[j].z, dp[i][j]);
                dp[i][j] = fmaf(ov.w, vv[j].w, dp[i][j]);
            }
        }
    }
#pragma unroll
    for (int i = 0; i < kRQ; ++i) {
        const int r = ty * kRQ + i;
        const float lse = sL[r], dd = sD[r];
#pragma unroll
        for (int j = 0; j < C::kCK; ++j) {
            const int c = tx + 16 * j;
            const float p = live(q0 + r, k0 + c, S, causal, window)
                                ? expf(s[i][j] * scale - lse) : 0.f;
            if (WANT_P) sP[r * C::kLdP + c] = p;
            sS[r * C::kLdP + c] = p * (dp[i][j] - dd);
        }
    }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ o, const float* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ delta, float* __restrict__ dq, int H, int KV, int S, int causal,
          int window, float scale) {
    using C = Cfg<HD>;
    constexpr int kBK = C::kBK;
    extern __shared__ float4 smem4[];
    float* sm = reinterpret_cast<float*>(smem4);
    float* sK = sm;
    float* sV = sm + C::kOffV;
    float* sQ = sm + C::kOffQ;
    float* sO = sm + C::kOffO;
    float* sS = sm + C::kOffS;
    float* sL = sm + C::kOffL;
    float* sD = sm + C::kOffD;

    const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest causal tiles first
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int kvh = h / (H / KV);
    const int ty = threadIdx.x / 16;
    const int tx = threadIdx.x % 16;
    const size_t row_bh = (static_cast<size_t>(b) * H + h) * S;  // first row of (b, h)
    const size_t row_bk = (static_cast<size_t>(b) * KV + kvh) * S;
    const int q_valid = min(kBQ, S - q0);

    stage<HD, kBQ, HD>(sQ, q + (row_bh + q0) * HD, q_valid);
    stage<HD, kBQ, HD>(sO, dout + (row_bh + q0) * HD, q_valid);
    __syncthreads();

    // D = rowsum(dO ∘ O) for this tile's rows: the 16 lanes of a row group
    // split the columns, then reduce; the dK/dV kernel reads it from delta
#pragma unroll
    for (int i = 0; i < kRQ; ++i) {
        const int r = ty * kRQ + i;
        float part = 0.f;
        if (r < q_valid) {
            const float* orow = o + (row_bh + q0 + r) * HD;
#pragma unroll
            for (int c = 0; c < C::kCols; ++c)
                part = fmaf(sO[r * HD + tx + 16 * c], orow[tx + 16 * c], part);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        if (tx == 0) {
            sD[r] = part;
            sL[r] = r < q_valid ? lse[row_bh + q0 + r] : 0.f;
            if (r < q_valid) delta[row_bh + q0 + r] = part;
        }
    }

    // K/V tiles some row of this q tile can see: [t_lo, t_hi)
    const int n_tiles = (S + kBK - 1) / kBK;
    int t_hi = n_tiles;
    if (causal) t_hi = min(n_tiles, (q0 + q_valid - 1) / kBK + 1);
    int t_lo = 0;
    if (window > 0 && q0 - window + 1 > 0) t_lo = (q0 - window + 1) / kBK;

    float acc[kRQ][C::kCols];
#pragma unroll
    for (int i = 0; i < kRQ; ++i)
#pragma unroll
        for (int c = 0; c < C::kCols; ++c) acc[i][c] = 0.f;

    for (int t = t_lo; t < t_hi; ++t) {
        const int k0 = t * kBK;
        __syncthreads();  // the previous tile's K and dS reads are done
        stage<HD, kBK, C::kLdK>(sK, k + (row_bk + k0) * HD, min(kBK, S - k0));
        stage<HD, kBK, C::kLdK>(sV, v + (row_bk + k0) * HD, min(kBK, S - k0));
        __syncthreads();
        scores<HD, false>(sK, sV, sQ, sO, sL, sD, nullptr, sS, q0, k0, S, causal, window,
                             scale);
        __syncthreads();
        // dQ[r][c] += sum_key dS[r][key] K[key][c]
#pragma unroll 2
        for (int kk = 0; kk < kBK; kk += 4) {
            float4 ds[kRQ];
#pragma unroll
            for (int i = 0; i < kRQ; ++i)
                ds[i] = *reinterpret_cast<const float4*>(sS + (ty * kRQ + i) * C::kLdP + kk);
#pragma unroll
            for (int c = 0; c < C::kCols; ++c) {
                const float k0v = sK[(kk + 0) * C::kLdK + tx + 16 * c];
                const float k1v = sK[(kk + 1) * C::kLdK + tx + 16 * c];
                const float k2v = sK[(kk + 2) * C::kLdK + tx + 16 * c];
                const float k3v = sK[(kk + 3) * C::kLdK + tx + 16 * c];
#pragma unroll
                for (int i = 0; i < kRQ; ++i) {
                    acc[i][c] = fmaf(ds[i].x, k0v, acc[i][c]);
                    acc[i][c] = fmaf(ds[i].y, k1v, acc[i][c]);
                    acc[i][c] = fmaf(ds[i].z, k2v, acc[i][c]);
                    acc[i][c] = fmaf(ds[i].w, k3v, acc[i][c]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < kRQ; ++i) {
        const int r = ty * kRQ + i;
        if (r >= q_valid) continue;
        float* drow = dq + (row_bh + q0 + r) * HD;
#pragma unroll
        for (int c = 0; c < C::kCols; ++c) drow[tx + 16 * c] = acc[i][c] * scale;
    }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            const float* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int H,
            int KV, int S, int causal, int window, float scale) {
    using C = Cfg<HD>;
    constexpr int kBK = C::kBK;
    constexpr int kRK = C::kRK;
    extern __shared__ float4 smem4[];
    float* sm = reinterpret_cast<float*>(smem4);
    float* sK = sm;
    float* sV = sm + C::kOffV;
    float* sQ = sm + C::kOffQ;
    float* sO = sm + C::kOffO;
    float* sP = sm + C::kOffP;
    float* sS = sm + C::kOffS;
    float* sL = sm + C::kOffL;
    float* sD = sm + C::kOffD;

    const int k0 = blockIdx.x * kBK;  // low K tiles (the most q tiles, causal) first
    const int kvh = blockIdx.y;
    const int b = blockIdx.z;
    const int group = H / KV;
    const int ty = threadIdx.x / 16;
    const int tx = threadIdx.x % 16;
    const size_t row_bk = (static_cast<size_t>(b) * KV + kvh) * S;
    const int k_valid = min(kBK, S - k0);

    stage<HD, kBK, C::kLdK>(sK, k + (row_bk + k0) * HD, k_valid);
    stage<HD, kBK, C::kLdK>(sV, v + (row_bk + k0) * HD, k_valid);

    // q tiles some key of this tile is seen by: [u_lo, u_hi)
    const int n_qtiles = (S + kBQ - 1) / kBQ;
    const int u_lo = causal ? k0 / kBQ : 0;
    int u_hi = n_qtiles;
    if (window > 0) u_hi = min(n_qtiles, (k0 + k_valid - 1 + window - 1) / kBQ + 1);

    float acc_k[kRK][C::kCols], acc_v[kRK][C::kCols];
#pragma unroll
    for (int i = 0; i < kRK; ++i)
#pragma unroll
        for (int c = 0; c < C::kCols; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

    for (int g = 0; g < group; ++g) {
        const size_t row_bh = (static_cast<size_t>(b) * H + kvh * group + g) * S;
        for (int u = u_lo; u < u_hi; ++u) {
            const int q0 = u * kBQ;
            const int q_valid = min(kBQ, S - q0);
            __syncthreads();  // the previous q tile's reads are done
            stage<HD, kBQ, HD>(sQ, q + (row_bh + q0) * HD, q_valid);
            stage<HD, kBQ, HD>(sO, dout + (row_bh + q0) * HD, q_valid);
            if (threadIdx.x < kBQ) {
                const int r = threadIdx.x;
                sL[r] = r < q_valid ? lse[row_bh + q0 + r] : 0.f;
                sD[r] = r < q_valid ? delta[row_bh + q0 + r] : 0.f;
            }
            __syncthreads();
            scores<HD, true>(sK, sV, sQ, sO, sL, sD, sP, sS, q0, k0, S, causal, window,
                                scale);
            __syncthreads();
            // dV[key][c] += sum_r P[r][key] dO[r][c];  dK[key][c] += sum_r dS[r][key] Q[r][c]
#pragma unroll 2
            for (int r = 0; r < kBQ; ++r) {
                float p[kRK], ds[kRK];
#pragma unroll
                for (int i = 0; i < kRK; i += 4) {
                    const float4 p4 = *reinterpret_cast<const float4*>(sP + r * C::kLdP + ty * kRK + i);
                    const float4 s4 = *reinterpret_cast<const float4*>(sS + r * C::kLdP + ty * kRK + i);
                    p[i] = p4.x; p[i + 1] = p4.y; p[i + 2] = p4.z; p[i + 3] = p4.w;
                    ds[i] = s4.x; ds[i + 1] = s4.y; ds[i + 2] = s4.z; ds[i + 3] = s4.w;
                }
#pragma unroll
                for (int c = 0; c < C::kCols; ++c) {
                    const float ov = sO[r * HD + tx + 16 * c];
                    const float qv = sQ[r * HD + tx + 16 * c];
#pragma unroll
                    for (int i = 0; i < kRK; ++i) {
                        acc_v[i][c] = fmaf(p[i], ov, acc_v[i][c]);
                        acc_k[i][c] = fmaf(ds[i], qv, acc_k[i][c]);
                    }
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < kRK; ++i) {
        const int r = ty * kRK + i;
        if (r >= k_valid) continue;
        float* krow = dk + (row_bk + k0 + r) * HD;
        float* vrow = dv + (row_bk + k0 + r) * HD;
#pragma unroll
        for (int c = 0; c < C::kCols; ++c) {
            krow[tx + 16 * c] = acc_k[i][c] * scale;
            vrow[tx + 16 * c] = acc_v[i][c];
        }
    }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq, void* dk,
                   void* dv, int B, int H, int KV, int S, int causal, int window, float scale,
                   cudaStream_t stream) {
    using C = Cfg<HD>;
    // above 48 KiB of dynamic shared memory a kernel must opt in; set on every
    // call: cheap next to the kernels and free of races
    cudaError_t err = cudaFuncSetAttribute(dq_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(C::kBytes));
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(dkdv_kernel<HD>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(C::kBytes));
    if (err != cudaSuccess) return err;
    const float* tq = static_cast<const float*>(q);
    const float* tk = static_cast<const float*>(k);
    const float* tv = static_cast<const float*>(v);
    const float* tdo = static_cast<const float*>(dout);
    dq_kernel<HD><<<dim3((S + kBQ - 1) / kBQ, H, B), kThreads, C::kBytes, stream>>>(
        tq, tk, tv, static_cast<const float*>(o), tdo, lse, delta, static_cast<float*>(dq), H,
        KV, S, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dkdv_kernel<HD><<<dim3((S + C::kBK - 1) / C::kBK, KV, B), kThreads, C::kBytes, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), H, KV,
        S, causal, window, scale);
    return cudaGetLastError();
}

cudaError_t launch_hd(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* delta, void* dq, void* dk,
                      void* dv, int B, int H, int KV, int S, int hd, int causal, int window,
                      float scale, cudaStream_t stream) {
    switch (hd) {
        case 32: return launch<32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KV, S,
                                   causal, window, scale, stream);
        case 64: return launch<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KV, S,
                                   causal, window, scale, stream);
        case 128: return launch<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KV, S,
                                     causal, window, scale, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace simt

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kBK = 64;   // dK/dV kernel: keys per CTA, 16 a warp
constexpr int kBQ = 32;   // dK/dV kernel: q rows per tile
constexpr int kBQ2 = 64;  // dQ kernel: q rows per CTA, 16 a warp
constexpr int kBK2 = 64;  // dQ kernel: keys per tile

template <int HD>
struct Cfg {
    static constexpr int kLd = HD + 8;  // bf16 elements per row in shared memory
    // dK/dV kernel: K | V | Q | dO | lse | D
    static constexpr size_t kBytesKV = 2 * (2 * kBK + 2 * kBQ) * kLd + 8 * kBQ;
    // dQ kernel: Q | dO | K | V | lse | D
    static constexpr size_t kBytesQ = 2 * (2 * kBQ2 + 2 * kBK2) * kLd + 8 * kBQ2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix i / 8
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) · b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// Lane addresses of the three operand loads, for a 16 x 16 block at (row r0, col c0)
// of a row-major bf16 tile with kLd elements a row:
//  * A, or B of two n8 tiles stored [n][k] (k contiguous): matrix m = lane / 8 covers
//    rows 8 (m & 1) .. + 7 for A (cols 8 (m >> 1)), and for B rows (n) 8 (m >> 1) .. + 7,
//    cols (k) 8 (m & 1);
//  * B of two n8 tiles stored [k][n] (n contiguous), loaded transposed: rows (k)
//    8 (m & 1) .. + 7, cols (n) 8 (m >> 1).
template <int LD>
__device__ __forceinline__ uint32_t a_addr(uint32_t base, int r0, int c0, int lane) {
    return base + 2 * ((r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8);
}
template <int LD>
__device__ __forceinline__ uint32_t b_addr(uint32_t base, int n0, int k0, int lane) {
    return base + 2 * ((n0 + (lane >> 4) * 8 + (lane & 7)) * LD + k0 + ((lane >> 3) & 1) * 8);
}
template <int LD>
__device__ __forceinline__ uint32_t bt_addr(uint32_t base, int k0, int n0, int lane) {
    return base + 2 * ((k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + n0 + (lane >> 4) * 8);
}

// rows [0, ROWS) of a (rows, HD) bf16 slab into shared memory with LD elements a
// row; rows at or past `valid` become zeros
template <int HD, int ROWS, int LD>
__device__ __forceinline__ void stage(bf16* dst, const bf16* __restrict__ src, int valid) {
    constexpr int kChunks = HD / 8;  // 16-byte chunks a row
    for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
        const int r = i / kChunks;
        const int c = (i % kChunks) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (r < valid) v = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * HD + c));
        *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
    }
}

// d (16 x N, registers) = x (16 x HD rows r0.. of a tile) · yᵀ (N rows n0.. of another
// tile), both K-major in shared memory: N / 8 accumulator tiles
template <int HD, int N, int LD>
__device__ __forceinline__ void product_nt(float (&d)[N / 8][4], uint32_t x, int r0, uint32_t y,
                                           int n0, int lane) {
#pragma unroll
    for (int t = 0; t < N / 8; ++t) d[t][0] = d[t][1] = d[t][2] = d[t][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
        uint32_t a[4];
        ldsm(a, a_addr<LD>(x, r0, ks * 16, lane));
#pragma unroll
        for (int np = 0; np < N / 16; ++np) {
            uint32_t b[4];
            ldsm(b, b_addr<LD>(y, n0 + np * 16, ks * 16, lane));
            mma(d[2 * np], a, b[0], b[1]);
            mma(d[2 * np + 1], a, b[2], b[3]);
        }
    }
}

// acc (16 x HD) += p (16 x K, A fragments in registers) · y (K rows of a tile, N-major
// in shared memory, loaded transposed)
template <int HD, int K, int LD>
__device__ __forceinline__ void product_pv(float (&acc)[HD / 8][4], const uint32_t (&p)[K / 16][4],
                                           uint32_t y, int lane) {
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
            uint32_t b[4];
            ldsm_t(b, bt_addr<LD>(y, kk * 16, np * 16, lane));
            mma(acc[2 * np], p[kk], b[0], b[1]);
            mma(acc[2 * np + 1], p[kk], b[2], b[3]);
        }
    }
}

// the accumulator tiles 2kk and 2kk + 1 of c as the bf16 A fragment of k block kk
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4], const float (&c)[N / 8][4]) {
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
        a[kk][0] = pack(c[2 * kk][0], c[2 * kk][1]);
        a[kk][1] = pack(c[2 * kk][2], c[2 * kk][3]);
        a[kk][2] = pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
        a[kk][3] = pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
    }
}

// Accumulator layout of m16n8 (lane = 4 g + t): register 2 r + e of tile j holds row
// g + 8 r, column 8 j + 2 t + e.
template <int HD>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
            int KV, int S, int causal, int window, float scale) {
    constexpr int LD = Cfg<HD>::kLd;
    extern __shared__ float4 smem4[];
    bf16* sK = reinterpret_cast<bf16*>(smem4);
    bf16* sV = sK + kBK * LD;
    bf16* sQ = sV + kBK * LD;
    bf16* sO = sQ + kBQ * LD;  // dO
    float* sL = reinterpret_cast<float*>(sO + kBQ * LD);
    float* sD = sL + kBQ;

    const int k0 = blockIdx.x * kBK;  // low K tiles (the most q tiles, causal) first
    const int kvh = blockIdx.y;
    const int b = blockIdx.z;
    const int group = H / KV;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int kw = 16 * warp;  // this warp's keys in the tile
    const size_t row_bk = (static_cast<size_t>(b) * KV + kvh) * S;
    const int k_valid = min(kBK, S - k0);

    stage<HD, kBK, LD>(sK, k + (row_bk + k0) * HD, k_valid);
    stage<HD, kBK, LD>(sV, v + (row_bk + k0) * HD, k_valid);

    const int n_qtiles = (S + kBQ - 1) / kBQ;
    const int u_lo = causal ? k0 / kBQ : 0;
    int u_hi = n_qtiles;
    if (window > 0) u_hi = min(n_qtiles, (k0 + k_valid - 1 + window - 1) / kBQ + 1);

    float acc_k[HD / 8][4], acc_v[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc_k[j][i] = acc_v[j][i] = 0.f;

    for (int h = 0; h < group; ++h) {
        const size_t row_bh = (static_cast<size_t>(b) * H + kvh * group + h) * S;
        for (int u = u_lo; u < u_hi; ++u) {
            const int q0 = u * kBQ;
            const int q_valid = min(kBQ, S - q0);
            __syncthreads();  // the previous q tile's reads are done
            stage<HD, kBQ, LD>(sQ, q + (row_bh + q0) * HD, q_valid);
            stage<HD, kBQ, LD>(sO, dout + (row_bh + q0) * HD, q_valid);
            if (threadIdx.x < kBQ) {
                const int r = threadIdx.x;
                sL[r] = r < q_valid ? lse[row_bh + q0 + r] : 0.f;
                sD[r] = r < q_valid ? delta[row_bh + q0 + r] : 0.f;
            }
            __syncthreads();
            // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: this warp's 16 keys x the tile's kBQ q rows
            float st[kBQ / 8][4], dpt[kBQ / 8][4];
            product_nt<HD, kBQ, LD>(st, smem_addr(sK), kw, smem_addr(sQ), 0, lane);
            product_nt<HD, kBQ, LD>(dpt, smem_addr(sV), kw, smem_addr(sO), 0, lane);
            // Pᵀ and dSᵀ in place: row = key, column = q row
#pragma unroll
            for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int key = k0 + kw + g + 8 * (i >> 1);
                    const int qr = 8 * j + 2 * t + (i & 1);
                    const float p = live(q0 + qr, key, S, causal, window)
                                        ? expf(st[j][i] * scale - sL[qr]) : 0.f;
                    st[j][i] = p;
                    dpt[j][i] = p * (dpt[j][i] - sD[qr]);
                }
            uint32_t pa[kBQ / 16][4], sa[kBQ / 16][4];
            to_a<kBQ>(pa, st);
            to_a<kBQ>(sa, dpt);
            // dV += Pᵀ dO, dK += dSᵀ Q (k = the tile's q rows)
            product_pv<HD, kBQ, LD>(acc_v, pa, smem_addr(sO), lane);
            product_pv<HD, kBQ, LD>(acc_k, sa, smem_addr(sQ), lane);
        }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int key = kw + g + 8 * r;
        if (key >= k_valid) continue;
        bf16* krow = dk + (row_bk + k0 + key) * HD;
        bf16* vrow = dv + (row_bk + k0 + key) * HD;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
            const int c = 8 * j + 2 * t;
            *reinterpret_cast<__nv_bfloat162*>(krow + c) =
                __floats2bfloat162_rn(acc_k[j][2 * r] * scale, acc_k[j][2 * r + 1] * scale);
            *reinterpret_cast<__nv_bfloat162*>(vrow + c) =
                __floats2bfloat162_rn(acc_v[j][2 * r], acc_v[j][2 * r + 1]);
        }
    }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ o, const bf16* __restrict__ dout,
          const float* __restrict__ lse, float* __restrict__ delta, bf16* __restrict__ dq,
          int H, int KV, int S, int causal, int window, float scale) {
    constexpr int LD = Cfg<HD>::kLd;
    extern __shared__ float4 smem4[];
    bf16* sQ = reinterpret_cast<bf16*>(smem4);
    bf16* sO = sQ + kBQ2 * LD;  // dO
    bf16* sK = sO + kBQ2 * LD;
    bf16* sV = sK + kBK2 * LD;
    float* sL = reinterpret_cast<float*>(sV + kBK2 * LD);
    float* sD = sL + kBQ2;

    const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ2;  // heaviest causal tiles first
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int kvh = h / (H / KV);
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int qw = 16 * warp;  // this warp's q rows in the tile
    const size_t row_bh = (static_cast<size_t>(b) * H + h) * S;
    const size_t row_bk = (static_cast<size_t>(b) * KV + kvh) * S;
    const int q_valid = min(kBQ2, S - q0);

    stage<HD, kBQ2, LD>(sQ, q + (row_bh + q0) * HD, q_valid);
    stage<HD, kBQ2, LD>(sO, dout + (row_bh + q0) * HD, q_valid);
    __syncthreads();

    // D = rowsum(dO ∘ O) for this warp's 16 rows, the lanes splitting the columns;
    // the dK/dV kernel reads it from delta
    for (int rr = 0; rr < 16; ++rr) {
        const int r = qw + rr;
        float part = 0.f;
        if (r < q_valid) {
            const bf16* orow = o + (row_bh + q0 + r) * HD;
            for (int c = lane; c < HD; c += 32)
                part = fmaf(__bfloat162float(sO[r * LD + c]), __bfloat162float(orow[c]), part);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        if (lane == 0) {
            sD[r] = part;
            sL[r] = r < q_valid ? lse[row_bh + q0 + r] : 0.f;
            if (r < q_valid) delta[row_bh + q0 + r] = part;
        }
    }

    const int n_tiles = (S + kBK2 - 1) / kBK2;
    int t_hi = n_tiles;
    if (causal) t_hi = min(n_tiles, (q0 + q_valid - 1) / kBK2 + 1);
    int t_lo = 0;
    if (window > 0 && q0 - window + 1 > 0) t_lo = (q0 - window + 1) / kBK2;

    float acc[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    for (int tile = t_lo; tile < t_hi; ++tile) {
        const int k0 = tile * kBK2;
        __syncthreads();  // the previous tile's reads are done (and sL, sD written)
        stage<HD, kBK2, LD>(sK, k + (row_bk + k0) * HD, min(kBK2, S - k0));
        stage<HD, kBK2, LD>(sV, v + (row_bk + k0) * HD, min(kBK2, S - k0));
        __syncthreads();
        // S = Q Kᵀ and dP = dO Vᵀ: this warp's 16 q rows x the tile's kBK2 keys
        float s[kBK2 / 8][4], dp[kBK2 / 8][4];
        product_nt<HD, kBK2, LD>(s, smem_addr(sQ), qw, smem_addr(sK), 0, lane);
        product_nt<HD, kBK2, LD>(dp, smem_addr(sO), qw, smem_addr(sV), 0, lane);
#pragma unroll
        for (int j = 0; j < kBK2 / 8; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int qr = qw + g + 8 * (i >> 1);
                const int key = k0 + 8 * j + 2 * t + (i & 1);
                const float p = live(q0 + qr, key, S, causal, window)
                                    ? expf(s[j][i] * scale - sL[qr]) : 0.f;
                dp[j][i] = p * (dp[j][i] - sD[qr]);
            }
        uint32_t sa[kBK2 / 16][4];
        to_a<kBK2>(sa, dp);
        product_pv<HD, kBK2, LD>(acc, sa, smem_addr(sK), lane);  // dQ += dS K
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int qr = qw + g + 8 * r;
        if (qr >= q_valid) continue;
        bf16* drow = dq + (row_bh + q0 + qr) * HD;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(drow + 8 * j + 2 * t) =
                __floats2bfloat162_rn(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
    }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq, void* dk,
                   void* dv, int B, int H, int KV, int S, int causal, int window, float scale,
                   cudaStream_t stream) {
    using C = Cfg<HD>;
    cudaError_t err = cudaFuncSetAttribute(dq_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(C::kBytesQ));
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(C::kBytesKV));
    if (err != cudaSuccess) return err;
    const bf16* tq = static_cast<const bf16*>(q);
    const bf16* tk = static_cast<const bf16*>(k);
    const bf16* tv = static_cast<const bf16*>(v);
    const bf16* tdo = static_cast<const bf16*>(dout);
    dq_kernel<HD><<<dim3((S + kBQ2 - 1) / kBQ2, H, B), kThreads, C::kBytesQ, stream>>>(
        tq, tk, tv, static_cast<const bf16*>(o), tdo, lse, delta, static_cast<bf16*>(dq), H, KV,
        S, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dkdv_kernel<HD><<<dim3((S + kBK - 1) / kBK, KV, B), kThreads, C::kBytesKV, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, KV, S,
        causal, window, scale);
    return cudaGetLastError();
}

cudaError_t launch_hd(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* delta, void* dq, void* dk,
                      void* dv, int B, int H, int KV, int S, int hd, int causal, int window,
                      float scale, cudaStream_t stream) {
    switch (hd) {
        case 32: return launch<32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KV, S,
                                   causal, window, scale, stream);
        case 64: return launch<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KV, S,
                                   causal, window, scale, stream);
        case 128: return launch<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KV, S,
                                     causal, window, scale, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace tc
}  // namespace

// q/o/dout/dq (B,H,S,hd), k/v/dk/dv (B,KV,S,hd), all of one dtype, contiguous and
// 16-byte aligned; lse (B,H,S) f32 from the forward kernel; delta (B,H,S) f32
// scratch that the first kernel fills and the second reads. dtype: 0 = float32 (the
// SIMT kernels), 2 = bfloat16 (the tensor-core kernels); hd in {32, 64, 128}; H a multiple of KV. Returns the cudaError_t of
// the launches (0 = cudaSuccess); cudaErrorInvalidValue for an unsupported dtype
// or hd.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* delta, void* dq, void* dk, void* dv, int B,
                                          int H, int KV, int S, int hd, int dtype, int causal,
                                          int window, float scale, void* stream) {
    if (B <= 0 || H <= 0 || S <= 0) return cudaSuccess;
    if (KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* l = static_cast<const float*>(lse);
    float* d = static_cast<float*>(delta);
    switch (dtype) {
        case 0: return static_cast<int>(simt::launch_hd(
            q, k, v, o, dout, l, d, dq, dk, dv, B, H, KV, S, hd, causal, window, scale, st));
        case 2: return static_cast<int>(tc::launch_hd(
            q, k, v, o, dout, l, d, dq, dk, dv, B, H, KV, S, hd, causal, window, scale, st));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
