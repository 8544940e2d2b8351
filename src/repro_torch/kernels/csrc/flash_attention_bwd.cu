// Causal / sliding-window GQA attention, backward, for Hopper (sm_90a).
//
// The TPU kernel src/repro/kernels/flash_attention.py:flash_attention_fwd has no
// backward: the JAX train step differentiates its own attention through XLA
// (jax.value_and_grad over models/attention.py:gqa_attention). The port trains
// through its forward kernel (flash_attention.cu), so the gradient of that
// kernel's function is a kernel too. The semantics are the forward's: scores
// scale·q·kᵀ in f32, causal keeps kpos <= qpos and window > 0 adds kpos > qpos -
// window (both positions counted from 0, so the mask is top-left aligned when
// Sq != Sk), q head h reads KV head h / (H / KV). Sq q rows attend over Sk keys:
// the encoder-decoder's cross-attention has Sq = 448 text rows over Sk = 1,500
// audio frames. A key that no row sees gets dK = dV = 0; a row that sees no key
// gives no gradient (its P is 0), as the plain version's.
//
// The FlashAttention-2 backward. With the forward's per-row log-sum-exp (lse,
// natural log, f32) and D = rowsum(dO ∘ O):
//   P  = exp(scale·Q Kᵀ − lse)   (0 where masked)
//   dV = Pᵀ dO        dP = dO Vᵀ        dS = P ∘ (dP − D)
//   dK = scale · dSᵀ Q               dQ = scale · dS K
// Two kernels, one after the other on the caller's stream, and no atomics, so
// two calls give bit-equal gradients:
//   * dq_kernel: one CTA per (q tile of the Sq rows, q head, batch). It computes D
//     (and writes it with the LSE for the next kernel), then walks the K/V tiles
//     of the Sk keys its rows can see, rebuilding S, P, dP and dS, and accumulates
//     dQ in registers; the heaviest causal q tiles start first;
//   * dkdv_kernel: one CTA per (K/V tile of the Sk keys, KV head, batch). It keeps
//     its K and V tile in shared memory and walks the q heads of its GQA group
//     and, for each, the q tiles of the Sq rows that can see the tile (causal:
//     from the diagonal on; window: up to the last key + window − 1), accumulating
//     dK and dV in registers. So a group's q heads are summed by one CTA, in a
//     fixed order; the heaviest causal K/V tiles start first. A tile that no row
//     sees (causal, Sk > Sq) walks nothing and writes zeros: the outputs come
//     from torch.empty_like.
// Everything is accumulated in f32 and written once in the inputs' dtype.
//
// What bounds it: over the live (q row, key) pairs of a head it does seven
// products of the forward's size (Q·Kᵀ and dO·Vᵀ in both kernels, Pᵀ·dO, dSᵀ·Q,
// dS·K), so it is bound by operations at every training shape; the least time
// counts five (one kernel that adds dQ across CTAs would do five), so two kernels
// cannot come closer than 1.4× that bound. flash_attention_bwd_launch dispatches by dtype to
// one of two pairs of kernels.
//
// bfloat16: tc::, on the tensor cores, FlashAttention-3's shape of kernel, for (q·k, v)
// width pairs (DK, DV): hd 32-256, Kimi-K2's (112, 112) and DeepSeek-V3's MLA (192,
// 128). Q, K, dQ and dK tiles are padded(DK) wide, V, dO and dV tiles padded(DV)
// (sm90.cuh: whole 64-column boxes, so 112 is held as 128 over a 112-wide tensor
// map, TMA zero-filling the rest); S = Q Kᵀ, dQ and dK run over DK, dP = dO Vᵀ and
// dV over DV. Every direct access to device memory (D's rowsum over O and dO, the
// dQ, dK and dV stores) uses the true width as row stride and column bound:
//   * 384 threads a CTA: two consumer warpgroups and a producer warpgroup that
//     gives its registers up (setmaxnreg: 24 a thread) so that each consumer
//     thread can hold 240;
//   * bytes: one producer thread TMA-loads the resident tiles once and each
//     visited tile into a 2-stage ring, an mbarrier per stage for "full" (TMA
//     transaction bytes) and one for "empty" (an arrival per consumer warpgroup
//     once its last product on the stage has retired), so the next tile's load
//     overlaps this tile's products. Tensor maps are the forward's, 3-D (width,
//     rows, B·heads), Sq rows for Q and dO and Sk for K and V: rows past the end are
//     zero-filled inside their own head (sm90.cuh);
//   * operations: every product is wgmma m64nNk16, bf16 in, f32 accumulators in
//     registers. Q·Kᵀ-shaped products (S, dP; Sᵀ = K Qᵀ, dPᵀ = V dOᵀ) read both
//     operands from shared memory K-major. P·V-shaped ones (dQ += dS K, dV += Pᵀ
//     dO, dK += dSᵀ Q) take P or dS from registers — the m64 accumulator layout is
//     the register A layout once rounded to bf16 in place, as the forward does
//     with P — and read K, dO or Q MN-major through the transpose bit. So one
//     copy of a Q or dO tile in shared memory serves both readings: the swizzle
//     atoms are the same, only the descriptor's offsets differ;
//   * dq_kernel: Q and dO of 128 rows resident, 64 a warpgroup; K/V tiles of 128
//     keys (64 at (192, 128), where a ring of 128 would need 240 KB; 32 at hd 256,
//     where Q and dO take 128 KB); S and dP are issued
//     together and dP runs while P is formed. D is summed by each quad from O
//     and dO in device memory, O in f32 as the forward kernel wrote it before
//     rounding (flash_attention.cu: from the bf16 O, D's error times the mean key
//     can outgrow dQ itself), and the LSE (in log2 units) and D are written to
//     a scratch of one row a query, padded with zeros to 64-row chunks;
//   * dkdv_kernel: K and V of 128 keys resident, 64 a warpgroup owning their dK
//     and dV; Q and dO tiles of 64 rows and their LSE and D rows (two bulk copies
//     from the scratch) through the ring. Each product is its own wgmma group:
//     dPᵀ runs while Pᵀ is formed, dV += Pᵀ dO while dSᵀ is. At hd 256 dK + dV of 64
//     keys would be 256 f32 a thread, past the 255 a thread may have, and at (192,
//     128) dK, dV, Sᵀ and dPᵀ 224 of a consumer's 240, so there the CTA takes 64 keys,
//     warpgroup 0 computes Pᵀ and owns dV, warpgroup 1 computes dPᵀ and owns dK,
//     and Pᵀ passes from 0 to 1 through 16 KB of shared memory under two named
//     barriers, as FlashAttention-3 does at hd 256;
//   * masks are built only on tiles that cross Sq or Sk, the diagonal or the window
//     edge; P rounds to bf16 as the forward's P·V product rounds it, dS once
//     (about 2^-9 relative), inside the bf16 tolerance of 2e-2.
//   Shared memory at hd 128 (and 112): 192 KB (dQ) and 129 KB (dK/dV); at (192, 128)
//   160 KB and 137 KB; at hd 256 192 KB and 209 KB of the 227 KB a CTA may have. One CTA an SM. A third ring stage
//   measured no faster; issuing the next tile's S behind this tile's dQ product
//   measured slower (it holds each stage longer).
//
// float32: simt::, at dk == dv in 32, 64 and 128, on the f32 SIMT pipes (67 TFLOP/s; on the tensor cores f32 would
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
//   Rows past Sq and keys past Sk are staged as zeros and masked, so neither need
//   be a multiple of a tile. hd 256 is not instantiated in f32: no model trains there in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"  // mbarriers, TMA, wgmma, tensor maps (shared with the forward)

namespace {

__device__ __forceinline__ bool live(int qpos, int kpos, int Sq, int Sk, int causal,
                                     int window) {
    bool ok = qpos < Sq && kpos < Sk;
    if (causal) ok = ok && kpos <= qpos;
    if (window > 0) ok = ok && kpos > qpos - window;
    return ok;
}

namespace simt {

constexpr int kThreads = 128;
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
                                       float* sP, float* sS, int q0, int k0, int Sq,
                                       int Sk, int causal, int window, float scale) {
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
            const float p = live(q0 + r, k0 + c, Sq, Sk, causal, window)
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
          float* __restrict__ delta, float* __restrict__ dq, int H, int KV, int Sq, int Sk,
          int causal, int window, float scale) {
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
    const size_t row_bh = (static_cast<size_t>(b) * H + h) * Sq;  // first row of (b, h)
    const size_t row_bk = (static_cast<size_t>(b) * KV + kvh) * Sk;
    const int q_valid = min(kBQ, Sq - q0);

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
    const int n_tiles = (Sk + kBK - 1) / kBK;
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
        stage<HD, kBK, C::kLdK>(sK, k + (row_bk + k0) * HD, min(kBK, Sk - k0));
        stage<HD, kBK, C::kLdK>(sV, v + (row_bk + k0) * HD, min(kBK, Sk - k0));
        __syncthreads();
        scores<HD, false>(sK, sV, sQ, sO, sL, sD, nullptr, sS, q0, k0, Sq, Sk, causal,
                          window, scale);
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
            int KV, int Sq, int Sk, int causal, int window, float scale) {
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
    const size_t row_bk = (static_cast<size_t>(b) * KV + kvh) * Sk;
    const int k_valid = min(kBK, Sk - k0);

    stage<HD, kBK, C::kLdK>(sK, k + (row_bk + k0) * HD, k_valid);
    stage<HD, kBK, C::kLdK>(sV, v + (row_bk + k0) * HD, k_valid);

    // q tiles some key of this tile is seen by: [u_lo, u_hi), empty for keys that
    // no row sees (causal, k0 >= Sq), whose dK and dV are then written as zeros
    const int n_qtiles = (Sq + kBQ - 1) / kBQ;
    const int u_lo = causal ? k0 / kBQ : 0;
    int u_hi = n_qtiles;
    if (window > 0) u_hi = min(n_qtiles, (k0 + k_valid - 1 + window - 1) / kBQ + 1);

    float acc_k[kRK][C::kCols], acc_v[kRK][C::kCols];
#pragma unroll
    for (int i = 0; i < kRK; ++i)
#pragma unroll
        for (int c = 0; c < C::kCols; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

    for (int g = 0; g < group; ++g) {
        const size_t row_bh = (static_cast<size_t>(b) * H + kvh * group + g) * Sq;
        for (int u = u_lo; u < u_hi; ++u) {
            const int q0 = u * kBQ;
            const int q_valid = min(kBQ, Sq - q0);
            __syncthreads();  // the previous q tile's reads are done
            stage<HD, kBQ, HD>(sQ, q + (row_bh + q0) * HD, q_valid);
            stage<HD, kBQ, HD>(sO, dout + (row_bh + q0) * HD, q_valid);
            if (threadIdx.x < kBQ) {
                const int r = threadIdx.x;
                sL[r] = r < q_valid ? lse[row_bh + q0 + r] : 0.f;
                sD[r] = r < q_valid ? delta[row_bh + q0 + r] : 0.f;
            }
            __syncthreads();
            scores<HD, true>(sK, sV, sQ, sO, sL, sD, sP, sS, q0, k0, Sq, Sk, causal, window,
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
                   void* dv, int B, int H, int KV, int Sq, int Sk, int causal, int window,
                   float scale, cudaStream_t stream) {
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
    dq_kernel<HD><<<dim3((Sq + kBQ - 1) / kBQ, H, B), kThreads, C::kBytes, stream>>>(
        tq, tk, tv, static_cast<const float*>(o), tdo, lse, delta, static_cast<float*>(dq), H,
        KV, Sq, Sk, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dkdv_kernel<HD><<<dim3((Sk + C::kBK - 1) / C::kBK, KV, B), kThreads, C::kBytes, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), H, KV,
        Sq, Sk, causal, window, scale);
    return cudaGetLastError();
}

// the (q·k, v) width pairs of flash_attention.py's BWD_HEAD_DIMS for float32
cudaError_t launch_hd(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* delta, void* dq, void* dk,
                      void* dv, int B, int H, int KV, int Sq, int Sk, int dk_, int dv_,
                      int causal, int window, float scale, cudaStream_t stream) {
#define PAIR(DK, DV)                                                                       \
    if (dk_ == DK && dv_ == DV)                                                           \
        return launch<DK>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KV, Sq, Sk,    \
                          causal, window, scale, stream)
    PAIR(32, 32); PAIR(64, 64); PAIR(128, 128);
#undef PAIR
    return cudaErrorInvalidValue;
}

}  // namespace simt

namespace tc {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int kStages = 2;          // ring depth of both kernels
constexpr int kThreads = 384;       // two consumer warpgroups, then a producer warpgroup
constexpr int kProducerRegs = 24;   // a producer thread's registers after setmaxnreg
constexpr int kConsumerRegs = 240;  // a consumer thread's
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPFull = 1, kPEmpty = 2;  // named barriers of the Pᵀ handoff (hd 256)

// dQ kernel: Q and dO of 128 q rows resident (64 a consumer warpgroup), K/V
// tiles of kBK keys through the ring. Q and K tiles are KP = padded(DK) wide, dO
// and V tiles VP = padded(DV). Shared memory: Q | dO | K[kStages] | V[kStages] |
// mbarriers. K/V tiles are 128 keys (192 KB at hd 128), so S and dP run as m64n128:
// at the tensor cores' peak its operands ask shared memory for 96 bytes a clock,
// m64n64's for all 128 an SM has. Where a 2-stage ring of 128 keys does not fit
// beside Q and dO the tiles are smaller: 64 keys at (192, 128) (Q 48 KB + dO 32 KB +
// 2 × (K 24 KB + V 16 KB) = 160 KB; 128 keys would take 240 KB), 32 at hd 256 (Q and
// dO alone take 128 KB: 2 × 2 × 16 KB).
template <int DK, int DV>
struct DqCfg {
    static constexpr int KP = padded(DK), VP = padded(DV);
    static constexpr int kBQ = 128;
    static constexpr int kBK = KP >= 256 ? 32 : KP + VP > 256 ? 64 : 128;
    static constexpr int kQBytes = Tile<KP>::bytes(kBQ);
    static constexpr int kOBytes = Tile<VP>::bytes(kBQ);
    static constexpr int kKBytes = Tile<KP>::bytes(kBK);
    static constexpr int kVBytes = Tile<VP>::bytes(kBK);
    static constexpr int kOffO = kQBytes;
    static constexpr int kOffK = kQBytes + kOBytes;
    static constexpr int kOffV = kOffK + kStages * kKBytes;
    static constexpr int kOffBar = kOffV + kStages * kVBytes;
    static constexpr int kBars = 1 + 3 * kStages;  // q_full, k_full[], v_full[], empty[]
    static constexpr size_t kBytes = kOffBar + 8 * kBars + 1024;  // + room to align to 1024
};

// dK/dV kernel: K and V of kBK keys resident, the (Q, dO) tiles of 64 q rows and
// their LSE and D rows through the ring; K and Q tiles KP wide, V and dO tiles VP.
// Where dK + dV + Sᵀ + dPᵀ of 64 keys fit a thread's registers (KP + VP <= 256:
// hd 32-128, 112) each consumer warpgroup owns 64 keys and both their dK and dV
// (kBK = 128). Past that (at hd 256 dK + dV alone would be 256 f32 a thread; at
// (192, 128) the four come to 224 of the 240 a consumer has) both warpgroups take
// the same 64 keys, warpgroup 0 computes Pᵀ and owns dV, warpgroup 1 computes dPᵀ
// and owns dK, and Pᵀ passes from 0 to 1 through shared memory (kSplit).
// Shared memory: K | V | Q[kStages] | dO[kStages] | rows[kStages] | Pᵀ | mbarriers:
// 129 KB at hd 128, 137 KB at (192, 128), 209 KB at hd 256.
template <int DK, int DV>
struct KvCfg {
    static constexpr int KP = padded(DK), VP = padded(DV);
    static constexpr bool kSplit = KP + VP > 256;
    static constexpr int kBK = kSplit ? 64 : 128;
    static constexpr int kBQ = 64;
    static constexpr int kKBytes = Tile<KP>::bytes(kBK);
    static constexpr int kVBytes = Tile<VP>::bytes(kBK);
    static constexpr int kQBytes = Tile<KP>::bytes(kBQ);
    static constexpr int kOBytes = Tile<VP>::bytes(kBQ);
    static constexpr int kRowsBytes = 2 * kBQ * 4;  // a stage's LSE (log2 units) and D
    static constexpr int kPBytes = kSplit ? 64 * kBQ * 4 : 0;
    static constexpr int kOffV = kKBytes;
    static constexpr int kOffQ = kKBytes + kVBytes;
    static constexpr int kOffO = kOffQ + kStages * kQBytes;
    static constexpr int kOffRows = kOffO + kStages * kOBytes;
    static constexpr int kOffP = kOffRows + kStages * kRowsBytes;
    static constexpr int kOffBar = kOffP + kPBytes;
    static constexpr int kBars = 1 + 2 * kStages;  // kv_full, full[], empty[]
    static constexpr size_t kBytes = kOffBar + 8 * kBars + 1024;
};

// Accumulator layout of wgmma m64nN: register 4j + 2r + e holds row r0 + 8r,
// column 8j + c + e, where r0 = 16 (warp % 4) + lane / 4 and c = 2 (lane % 4).

// d (64 x N) = A · Bᵀ over the first D columns: A rows [r0, r0 + 64) of a tile of
// a_rows rows, B an N-row tile, both K-major and padded(D) wide (the D/16 k16 steps
// with data; a padded width's zero columns are skipped). Issued as one wgmma group,
// not waited for.
template <int D, int N>
__device__ __forceinline__ void product_nt(float (&d)[N / 2], uint32_t a, int a_rows, int r0,
                                           uint32_t b) {
    constexpr int W = padded(D);
    pin(d);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
        mma_ss<N>(d, desc_k<W>(a, a_rows, r0, ks), desc_k<W>(b, N, 0, ks), ks > 0);
    wgmma_commit();
}

// acc (64 x W) += A · B: A (64 x K) bf16 in registers, B a K-row tile W wide read
// MN-major (its rows are the contraction). Issued as one wgmma group, not waited for.
template <int W, int K>
__device__ __forceinline__ void product_nn(float (&acc)[W / 2], uint32_t (&a)[K / 4],
                                           uint32_t b) {
    pin(acc);
    pin(a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk)
        mma_pv<W>(acc, &a[4 * kk], desc_mn<W>(b, K, kk), desc_mn<W>(b, K, kk, 2));
    wgmma_commit();
}

// dQ (and the LSE/D rows for the dK/dV kernel). One CTA per (q tile of 128 rows,
// q head, batch), the last (heaviest causal) q tiles first.
template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
          const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
          const float* __restrict__ o, const bf16* __restrict__ dout,
          const float* __restrict__ lse, float* __restrict__ rows, bf16* __restrict__ dq, int H,
          int KV, int Sq, int Sk, int S_pad, int causal, int window, float scale) {
    using C = DqCfg<DK, DV>;
    using TK = Tile<C::KP>;
    using TV = Tile<C::VP>;
    constexpr int kBQ = C::kBQ;
    constexpr int kBK = C::kBK;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;  // swizzle atoms need 1024
    const uint32_t sQ = base;
    const uint32_t sO = base + C::kOffO;
    const uint32_t sK = base + C::kOffK;
    const uint32_t sV = base + C::kOffV;
    const uint32_t q_full = base + C::kOffBar;
    auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
    auto v_full = [&](int s) { return q_full + 8 * (1 + kStages + s); };
    auto empty = [&](int s) { return q_full + 8 * (1 + 2 * kStages + s); };

    const int HB = gridDim.y * gridDim.z;
    const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    const int q0 = (gridDim.x - 1 - lin / HB) * kBQ;
    const int bh = lin % HB;  // b * H + h
    const int kvh = (bh / H) * KV + (bh % H) / (H / KV);
    const int q_rows = min(kBQ, Sq - q0);
    const int n_active = (q_rows + 63) / 64;  // warpgroups with a live row

    // the K/V tiles some row of this q tile can see: [t_lo, t_lo + n_visit)
    const int n_tiles = (Sk + kBK - 1) / kBK;
    int t_hi = n_tiles;
    if (causal) t_hi = min(n_tiles, (q0 + q_rows - 1) / kBK + 1);
    int t_lo = 0;
    if (window > 0 && q0 - window + 1 > 0) t_lo = (q0 - window + 1) / kBK;
    const int n_visit = max(0, t_hi - t_lo);

    if (threadIdx.x == 0) {
        bar_init(q_full, 1);
        for (int s = 0; s < kStages; ++s) {
            bar_init(k_full(s), 1);
            bar_init(v_full(s), 1);
            bar_init(empty(s), n_active);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (warp >= 8) {
        // producer: one thread issues every load; every box counts its full bytes,
        // the zero-filled columns of a padded width included
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(kProducerRegs));
        if (warp != 8 || lane != 0 || n_visit == 0) return;
        bar_expect_tx(q_full, C::kQBytes + C::kOBytes);
#pragma unroll
        for (int x = 0; x < TK::kBoxes; ++x)
            tma_load(sQ + x * TK::box(kBQ), &tm_q, q_full, x * TK::kBoxCols, q0, bh);
#pragma unroll
        for (int x = 0; x < TV::kBoxes; ++x)
            tma_load(sO + x * TV::box(kBQ), &tm_do, q_full, x * TV::kBoxCols, q0, bh);
        for (int i = 0; i < n_visit; ++i) {
            const int s = i % kStages;
            if (i >= kStages) bar_wait(empty(s), (i / kStages - 1) & 1);
            const int k0 = (t_lo + i) * kBK;
            bar_expect_tx(k_full(s), C::kKBytes);
#pragma unroll
            for (int x = 0; x < TK::kBoxes; ++x)
                tma_load(sK + s * C::kKBytes + x * TK::box(kBK), &tm_k, k_full(s),
                         x * TK::kBoxCols, k0, kvh);
            bar_expect_tx(v_full(s), C::kVBytes);
#pragma unroll
            for (int x = 0; x < TV::kBoxes; ++x)
                tma_load(sV + s * C::kVBytes + x * TV::box(kBK), &tm_v, v_full(s),
                         x * TV::kBoxCols, k0, kvh);
        }
        return;
    }

    // consumers: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(kConsumerRegs));
    const int wg = warp / 4;
    if (wg >= n_active) return;
    const int wg_lo = q0 + 64 * wg;
    const int wg_hi = min(wg_lo + 63, Sq - 1);
    const int row0 = wg_lo + 16 * (warp % 4) + lane / 4;  // this thread's rows: row0, row0 + 8
    const int col = 2 * (lane % 4);
    const float scale_log2 = scale * kLog2e;

    // each row's LSE in log2 units and D = rowsum(dO ∘ O) over the DV columns (O and
    // dO rows DV apart), the four threads of a quad splitting the columns; written,
    // padded with zeros from Sq to S_pad rows, for the dK/dV kernel, which brings
    // them in by bulk copies of whole 64-row tiles (the last warpgroup with a live
    // row reaches S_pad)
    float lse2[2], dd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int qpos = row0 + 8 * r;
        float part = 0.f;
        lse2[r] = 0.f;
        if (qpos < Sq) {
            const size_t row = static_cast<size_t>(bh) * Sq + qpos;
            lse2[r] = lse[row] * kLog2e;
            const float4* orow = reinterpret_cast<const float4*>(o + row * DV);
            const uint4* drow = reinterpret_cast<const uint4*>(dout + row * DV);
            for (int c = lane % 4; c < DV / 8; c += 4) {  // 8 columns a step
                const uint4 d = __ldg(drow + c);
                const float4 a0 = __ldg(orow + 2 * c), a1 = __ldg(orow + 2 * c + 1);
                const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
                const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float2 df = __bfloat1622float2(d2[e]);
                    part = fmaf(a[2 * e], df.x, fmaf(a[2 * e + 1], df.y, part));
                }
            }
        }
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        dd[r] = part;
        if (lane % 4 == 0 && qpos < S_pad) {
            rows[static_cast<size_t>(2 * bh) * S_pad + qpos] = lse2[r];
            rows[static_cast<size_t>(2 * bh + 1) * S_pad + qpos] = part;
        }
    }

    float acc[C::KP / 2];
    float s[kBK / 2], dp[kBK / 2];
    uint32_t ds[kBK / 4];
#pragma unroll
    for (int i = 0; i < C::KP / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] = dp[i] = 0.f;

    if (n_visit > 0) bar_wait(q_full, 0);
    for (int i = 0; i < n_visit; ++i) {
        const int st = i % kStages;
        const int parity = (i / kStages) & 1;
        const int k0 = (t_lo + i) * kBK;
        const uint32_t tK = sK + st * C::kKBytes;

        // S = Q Kᵀ over DK, then dP = dO Vᵀ over DV (both operands K-major), which
        // runs while P is formed from S
        bar_wait(k_full(st), parity);
        product_nt<DK, kBK>(s, sQ, kBQ, 64 * wg, tK);
        bar_wait(v_full(st), parity);
        product_nt<DV, kBK>(dp, sO, kBQ, 64 * wg, sV + st * C::kVBytes);
        wgmma_wait<1>();
        pin(s);

        // P = exp(scale·S − lse), 0 where masked (masks only on tiles that cross Sk,
        // the diagonal or the window edge; rows past Sq are never stored), then
        // dS = P ∘ (dP − D), in place
        const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > wg_lo) ||
                          (window > 0 && k0 <= wg_hi - window);
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float& x = s[4 * j + 2 * r + e];
                    const float p = exp2_approx(x * scale_log2 - lse2[r]);
                    const bool ok = !edge || live(row0 + 8 * r, k0 + 8 * j + col + e, Sq, Sk,
                                                  causal, window);
                    x = ok ? p : 0.f;
                }
        wgmma_wait<0>();
        pin(dp);
#pragma unroll
        for (int x = 0; x < kBK / 2; ++x) dp[x] = s[x] * (dp[x] - dd[(x >> 1) & 1]);
        to_a<kBK>(ds, dp);

        // dQ += dS K: K read MN-major (its keys are the contraction)
        product_nn<C::KP, kBK>(acc, ds, tK);
        wgmma_wait<0>();
        pin(acc);
        pin(ds);
        if (threadIdx.x % 128 == 0) bar_arrive(empty(st));  // this warpgroup is done with the stage
    }

    // the DK columns, rows DK apart (a padded width's last columns are not stored)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int qpos = row0 + 8 * r;
        if (qpos >= Sq) continue;
        bf16* drow = dq + (static_cast<size_t>(bh) * Sq + qpos) * DK + col;
#pragma unroll
        for (int j = 0; j < DK / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(drow + 8 * j) =
                __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
    }
}

// What a dK/dV consumer warpgroup needs of its CTA.
struct KvArgs {
    uint32_t sK, sV, sQ, sO;  // K and V; the stage-0 Q and dO tiles
    uint32_t kv_full, full, empty;  // full and empty: stage 0's, 8 bytes a stage
    const float* rows;  // stage 0's LSE (log2 units) and D rows, generic address
    float* p;           // the Pᵀ handoff (KvCfg::kSplit)
    int k0, Sq, Sk, causal, window, n_visit, per_head, u_lo;
};

enum Role { kBoth, kOnlyV, kOnlyK };

// A consumer warpgroup of the dK/dV kernel over the CTA's walk: kBoth owns its 64
// keys' dV and dK; where they do not fit (KvCfg::kSplit) kOnlyV owns dV and hands
// Pᵀ to kOnlyK, which owns dK.
template <int DK, int DV, int R>
__device__ __forceinline__ void dkdv_consume(const KvArgs& a, int wg, bf16* __restrict__ dk,
                                             bf16* __restrict__ dv, size_t row_bk, float scale) {
    using C = KvCfg<DK, DV>;
    constexpr int kBQ = C::kBQ;
    constexpr bool kV = R != kOnlyK;
    constexpr bool kK = R != kOnlyV;
    const int lane = threadIdx.x % 32;
    const int t = threadIdx.x % 128;
    const int kr = R == kBoth ? 64 * wg : 0;  // this warpgroup's keys in the CTA's tile
    const int wk_lo = a.k0 + kr;
    const int key0 = wk_lo + 16 * (threadIdx.x / 32 % 4) + lane / 4;  // rows key0, key0 + 8
    const int col = 2 * (lane % 4);
    const float scale_log2 = scale * kLog2e;

    // a role's unused arrays keep one element (and so no registers to speak of)
    constexpr int kAccV = kV ? C::VP / 2 : 1, kAccK = kK ? C::KP / 2 : 1;
    float acc_v[kAccV], acc_k[kAccK];
    float s[kBQ / 2];            // Sᵀ, then Pᵀ
    float dp[kK ? kBQ / 2 : 1];  // dPᵀ, then dSᵀ
    uint32_t pa[kV ? kBQ / 4 : 1], sa[kK ? kBQ / 4 : 1];
#pragma unroll
    for (int i = 0; i < kAccV; ++i) acc_v[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kAccK; ++i) acc_k[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kBQ / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (kK ? kBQ / 2 : 1); ++i) dp[i] = 0.f;

    if (a.n_visit > 0) bar_wait(a.kv_full, 0);
    for (int i = 0; i < a.n_visit; ++i) {
        const int st = i % kStages;
        const int q0 = (a.u_lo + i % a.per_head) * kBQ;
        const uint32_t tQ = a.sQ + st * C::kQBytes;
        const uint32_t tO = a.sO + st * C::kOBytes;
        bar_wait(a.full + 8 * st, (i / kStages) & 1);

        // Sᵀ = K Qᵀ over DK and dPᵀ = V dOᵀ over DV (this warpgroup's 64 keys × the
        // tile's 64 q rows): A the resident K or V, B the ring's Q or dO, both
        // K-major. With both, dPᵀ runs while Pᵀ is formed.
        if constexpr (R != kOnlyK) product_nt<DK, kBQ>(s, a.sK, C::kBK, kr, tQ);
        if constexpr (R != kOnlyV) product_nt<DV, kBQ>(dp, a.sV, C::kBK, kr, tO);
        if constexpr (R == kBoth) wgmma_wait<1>();
        else wgmma_wait<0>();
        pin(s);

        // Pᵀ (row = key, column = q row) in place; masks only on tiles that cross
        // Sq, Sk, the diagonal or the window edge
        const float* lse2 = a.rows + st * 2 * kBQ;
        const float* dd = lse2 + kBQ;
        const bool edge = q0 + kBQ > a.Sq || wk_lo + 64 > a.Sk ||
                          (a.causal && wk_lo + 63 > q0) ||
                          (a.window > 0 && wk_lo <= q0 + kBQ - 1 - a.window);
        if constexpr (R != kOnlyK) {
#pragma unroll
            for (int j = 0; j < kBQ / 8; ++j) {
                const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + col);
#pragma unroll
                for (int r = 0; r < 2; ++r)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        float& x = s[4 * j + 2 * r + e];
                        const float p = exp2_approx(x * scale_log2 - (e ? l.y : l.x));
                        const bool ok = !edge || live(q0 + 8 * j + col + e, key0 + 8 * r, a.Sq,
                                                      a.Sk, a.causal, a.window);
                        x = ok ? p : 0.f;
                    }
            }
        }
        if constexpr (R == kOnlyV) {  // hand Pᵀ over: value x of thread t at [x][t]
            if (i > 0) named_sync(kPEmpty, 256);
#pragma unroll
            for (int x = 0; x < kBQ / 2; ++x) a.p[x * 128 + t] = s[x];
            named_arrive(kPFull, 256);
        }
        if constexpr (R == kOnlyK) {
            named_sync(kPFull, 256);
#pragma unroll
            for (int x = 0; x < kBQ / 2; ++x) s[x] = a.p[x * 128 + t];
            if (i + 1 < a.n_visit) named_arrive(kPEmpty, 256);
        }

        // dV += Pᵀ dO and dK += dSᵀ Q: the same dO and Q tiles, now read MN-major
        // (their q rows are the contraction); dV is issued first and runs while
        // dSᵀ = Pᵀ ∘ (dPᵀ − D) is formed
        if constexpr (kV) {
            to_a<kBQ>(pa, s);
            product_nn<C::VP, kBQ>(acc_v, pa, tO);
        }
        if constexpr (kK) {
            if constexpr (kV) wgmma_wait<1>();  // dPᵀ; dV may still run
            pin(dp);
#pragma unroll
            for (int j = 0; j < kBQ / 8; ++j) {
                const float2 d = *reinterpret_cast<const float2*>(dd + 8 * j + col);
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    float* x = &dp[4 * j + 2 * r];
                    x[0] = s[4 * j + 2 * r] * (x[0] - d.x);
                    x[1] = s[4 * j + 2 * r + 1] * (x[1] - d.y);
                }
            }
            to_a<kBQ>(sa, dp);
            product_nn<C::KP, kBQ>(acc_k, sa, tQ);
        }
        wgmma_wait<0>();
        pin(acc_v);
        pin(acc_k);
        pin(pa);
        pin(sa);
        if (t == 0) bar_arrive(a.empty + 8 * st);  // this warpgroup is done with the stage
    }

    // dV's DV columns (rows DV apart) and dK's DK columns (rows DK apart); a padded
    // width's last columns are not stored
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key >= a.Sk) continue;
        if constexpr (kV) {
            bf16* vrow = dv + (row_bk + key) * DV + col;
#pragma unroll
            for (int j = 0; j < DV / 8; ++j)
                *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * j) =
                    __floats2bfloat162_rn(acc_v[4 * j + 2 * r], acc_v[4 * j + 2 * r + 1]);
        }
        if constexpr (kK) {
            bf16* krow = dk + (row_bk + key) * DK + col;
#pragma unroll
            for (int j = 0; j < DK / 8; ++j)
                *reinterpret_cast<__nv_bfloat162*>(krow + 8 * j) = __floats2bfloat162_rn(
                    acc_k[4 * j + 2 * r] * scale, acc_k[4 * j + 2 * r + 1] * scale);
        }
    }
}

// dK and dV. One CTA per (K/V tile, KV head, batch), the first (heaviest causal)
// K/V tiles first. It walks its GQA group's q heads and, for each, the q tiles
// that see some key of its tile, in that fixed order: each sum has one owner. A
// tile that no q row sees (causal, k0 >= Sq) walks nothing: its consumers still
// run and store their zeroed dK and dV.
template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
            const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
            const float* __restrict__ rows, bf16* __restrict__ dk, bf16* __restrict__ dv,
            int H, int KV, int Sq, int Sk, int S_pad, int causal, int window, float scale) {
    using C = KvCfg<DK, DV>;
    using TK = Tile<C::KP>;
    using TV = Tile<C::VP>;
    constexpr int kBQ = C::kBQ;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
    uint8_t* gbase = smem_raw + (base - smem_addr(smem_raw));  // the same, as a pointer
    KvArgs a;
    a.sK = base;
    a.sV = base + C::kOffV;
    a.sQ = base + C::kOffQ;
    a.sO = base + C::kOffO;
    a.kv_full = base + C::kOffBar;
    a.full = a.kv_full + 8;
    a.empty = a.full + 8 * kStages;
    a.rows = reinterpret_cast<const float*>(gbase + C::kOffRows);
    a.p = reinterpret_cast<float*>(gbase + C::kOffP);
    const uint32_t sRows = base + C::kOffRows;

    const int KB = gridDim.y * gridDim.z;
    const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    a.k0 = (lin / KB) * C::kBK;
    const int bk = lin % KB;  // b * KV + kvh
    const int group = H / KV;
    const int bh0 = (bk / KV) * H + (bk % KV) * group;  // the group's first q head
    const int k_rows = min(C::kBK, Sk - a.k0);
    a.Sq = Sq;
    a.Sk = Sk;
    a.causal = causal;
    a.window = window;

    // the q tiles some key of this tile is live for: [u_lo, u_lo + per_head)
    const int n_q = (Sq + kBQ - 1) / kBQ;
    a.u_lo = causal ? a.k0 / kBQ : 0;
    int u_hi = n_q;
    if (window > 0) u_hi = min(n_q, (a.k0 + k_rows - 1 + window - 1) / kBQ + 1);
    a.per_head = max(0, u_hi - a.u_lo);
    a.n_visit = group * a.per_head;

    if (threadIdx.x == 0) {
        bar_init(a.kv_full, 1);
        for (int s = 0; s < kStages; ++s) {
            bar_init(a.full + 8 * s, 1);
            bar_init(a.empty + 8 * s, 2);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    const int warp = threadIdx.x / 32;
    if (warp >= 8) {
        // producer: one thread issues every load
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(kProducerRegs));
        if (warp != 8 || threadIdx.x % 32 != 0 || a.n_visit == 0) return;
        bar_expect_tx(a.kv_full, C::kKBytes + C::kVBytes);
#pragma unroll
        for (int x = 0; x < TK::kBoxes; ++x)
            tma_load(a.sK + x * TK::box(C::kBK), &tm_k, a.kv_full, x * TK::kBoxCols, a.k0, bk);
#pragma unroll
        for (int x = 0; x < TV::kBoxes; ++x)
            tma_load(a.sV + x * TV::box(C::kBK), &tm_v, a.kv_full, x * TV::kBoxCols, a.k0, bk);
        for (int i = 0; i < a.n_visit; ++i) {
            const int s = i % kStages;
            if (i >= kStages) bar_wait(a.empty + 8 * s, (i / kStages - 1) & 1);
            const int bh = bh0 + i / a.per_head;
            const int q0 = (a.u_lo + i % a.per_head) * kBQ;
            const uint32_t full = a.full + 8 * s;
            bar_expect_tx(full, C::kQBytes + C::kOBytes + C::kRowsBytes);
#pragma unroll
            for (int x = 0; x < TK::kBoxes; ++x)
                tma_load(a.sQ + s * C::kQBytes + x * TK::box(kBQ), &tm_q, full,
                         x * TK::kBoxCols, q0, bh);
#pragma unroll
            for (int x = 0; x < TV::kBoxes; ++x)
                tma_load(a.sO + s * C::kOBytes + x * TV::box(kBQ), &tm_do, full,
                         x * TV::kBoxCols, q0, bh);
            const float* r = rows + static_cast<size_t>(2 * bh) * S_pad + q0;
            bulk_load(sRows + s * C::kRowsBytes, r, kBQ * 4, full);
            bulk_load(sRows + s * C::kRowsBytes + kBQ * 4, r + S_pad, kBQ * 4, full);
        }
        return;
    }

    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(kConsumerRegs));
    const int wg = warp / 4;
    const size_t row_bk = static_cast<size_t>(bk) * Sk;
    if constexpr (C::kSplit) {
        if (wg == 0) dkdv_consume<DK, DV, kOnlyV>(a, wg, dk, dv, row_bk, scale);
        else dkdv_consume<DK, DV, kOnlyK>(a, wg, dk, dv, row_bk, scale);
    } else {
        dkdv_consume<DK, DV, kBoth>(a, wg, dk, dv, row_bk, scale);
    }
}

// The launch's plan, made by flash_attention.py:bwd_geometry: the LSE/D scratch's
// rows a head, and the tiles it planned with, which must be this build's own.
struct Plan {
    int S_pad;
    int dq_rows, dq_keys;  // DqCfg: q rows a CTA, keys a K/V tile
    int kv_keys, kv_rows;  // KvCfg: keys a CTA, q rows a ring tile
};

template <int DK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* rows, void* dq, void* dk,
                   void* dv, int B, int H, int KV, int Sq, int Sk, int causal, int window,
                   float scale, const Plan& plan, cudaStream_t stream) {
    using Q = DqCfg<DK, DV>;
    using K = KvCfg<DK, DV>;
    // the dK/dV kernel bulk-copies whole ring tiles of LSE/D rows (one row a
    // query), which the dQ kernel writes (zeros past Sq) up to its last
    // warpgroup's 64 rows
    if (plan.dq_rows != Q::kBQ || plan.dq_keys != Q::kBK || plan.kv_keys != K::kBK ||
        plan.kv_rows != K::kBQ || plan.S_pad < Sq || plan.S_pad % K::kBQ != 0)
        return cudaErrorInvalidValue;
    const int S_pad = plan.S_pad;
    cudaError_t err = bind_device_of(q);  // the encoder needs a current context
    if (err != cudaSuccess) return err;
    CUtensorMap dq_q, dq_do, dq_k, dq_v, kv_q, kv_do, kv_k, kv_v;
    // each kernel's maps: its resident tiles and its ring's tiles have their own box
    // rows; Q and dO have Sq rows a head, K and V Sk; Q and K are DK wide, V and dO
    // DV, each map the tensor's own width (a box past it is zero-filled)
    const int kbox = Tile<Q::KP>::kBoxCols, vbox = Tile<Q::VP>::kBoxCols;
    const struct {
        CUtensorMap* map; const void* ptr; int width, rows, heads, box_cols, box_rows;
    } maps[] = {
        {&dq_q, q, DK, Sq, B * H, kbox, Q::kBQ}, {&dq_do, dout, DV, Sq, B * H, vbox, Q::kBQ},
        {&dq_k, k, DK, Sk, B * KV, kbox, Q::kBK}, {&dq_v, v, DV, Sk, B * KV, vbox, Q::kBK},
        {&kv_q, q, DK, Sq, B * H, kbox, K::kBQ}, {&kv_do, dout, DV, Sq, B * H, vbox, K::kBQ},
        {&kv_k, k, DK, Sk, B * KV, kbox, K::kBK}, {&kv_v, v, DV, Sk, B * KV, vbox, K::kBK},
    };
    for (const auto& m : maps) {
        err = make_map(m.map, m.ptr, m.width, m.rows, m.heads, m.box_cols, m.box_rows);
        if (err != cudaSuccess) return err;
    }
    // above 48 KiB of dynamic shared memory a kernel must opt in; set on every
    // call: cheap next to the kernels and free of races
    err = cudaFuncSetAttribute(dq_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Q::kBytes));
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(dkdv_kernel<DK, DV>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(K::kBytes));
    if (err != cudaSuccess) return err;
    dq_kernel<DK, DV><<<dim3((Sq + Q::kBQ - 1) / Q::kBQ, H, B), kThreads, Q::kBytes, stream>>>(
        dq_q, dq_do, dq_k, dq_v, static_cast<const float*>(o), static_cast<const bf16*>(dout),
        lse, rows, static_cast<bf16*>(dq), H, KV, Sq, Sk, S_pad, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dkdv_kernel<DK, DV><<<dim3((Sk + K::kBK - 1) / K::kBK, KV, B), kThreads, K::kBytes,
                          stream>>>(
        kv_q, kv_do, kv_k, kv_v, rows, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, KV,
        Sq, Sk, S_pad, causal, window, scale);
    return cudaGetLastError();
}

// the (q·k, v) width pairs of flash_attention.py's BWD_HEAD_DIMS for bfloat16
cudaError_t launch_hd(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* rows, void* dq, void* dk,
                      void* dv, int B, int H, int KV, int Sq, int Sk, int dk_, int dv_,
                      int causal, int window, float scale, const Plan& plan,
                      cudaStream_t stream) {
#define PAIR(DK, DV)                                                                         \
    if (dk_ == DK && dv_ == DV)                                                             \
        return launch<DK, DV>(q, k, v, o, dout, lse, rows, dq, dk, dv, B, H, KV, Sq, Sk,   \
                              causal, window, scale, plan, stream)
    PAIR(32, 32); PAIR(64, 64); PAIR(112, 112); PAIR(128, 128); PAIR(192, 128); PAIR(256, 256);
#undef PAIR
    return cudaErrorInvalidValue;
}

}  // namespace tc
}  // namespace

// q/dq (B,H,Sq,dk), k/dk (B,KV,Sk,dk), v/dv (B,KV,Sk,dv), o/dout (B,H,Sq,dv), all of
// one dtype but o, which is float32 for both (for bf16 the forward's output before its
// rounding), contiguous and 16-byte aligned; lse (B,H,Sq) f32 from the forward kernel;
// delta f32 scratch that the first kernel fills and the second reads: B·H·2·S_pad
// floats (the f32 kernels use its first B·H·Sq). S_pad and the four tile sizes are the
// plan of flash_attention.py:bwd_geometry; the bf16 kernels take S_pad >= Sq, a
// multiple of their 64-row ring tile, and only their own tiles. dtype: 0 = float32
// (the SIMT kernels; (dk, dv) (32, 32), (64, 64), (128, 128)), 2 = bfloat16 (the
// tensor-core kernels; also (112, 112), (192, 128) and (256, 256)); H a multiple of
// KV. Returns the cudaError_t of the launches (0 = cudaSuccess); cudaErrorInvalidValue
// for an unsupported dtype or width pair, a plan not the kernels' own, or a tensor map
// the driver refuses; cudaErrorNotSupported if the driver has no cuTensorMapEncodeTiled.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* delta, void* dq, void* dk, void* dv, int B,
                                          int H, int KV, int Sq, int Sk, int dk_w, int dv_w,
                                          int dtype, int causal, int window, int S_pad,
                                          int dq_rows, int dq_keys, int kv_keys, int kv_rows,
                                          float scale, void* stream) {
    if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return cudaSuccess;
    if (KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* l = static_cast<const float*>(lse);
    float* d = static_cast<float*>(delta);
    switch (dtype) {
        case 0: return static_cast<int>(simt::launch_hd(
            q, k, v, o, dout, l, d, dq, dk, dv, B, H, KV, Sq, Sk, dk_w, dv_w, causal, window,
            scale, st));
        case 2: return static_cast<int>(tc::launch_hd(
            q, k, v, o, dout, l, d, dq, dk, dv, B, H, KV, Sq, Sk, dk_w, dv_w, causal, window,
            scale, tc::Plan{S_pad, dq_rows, dq_keys, kv_keys, kv_rows}, st));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
