// Mamba2 SSD chunked scan, backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package trains through XLA's gradient of
// src/repro/models/mamba.py:ssd_chunked (its Pallas kernel ssd_scan.py:ssd_scan_fwd is
// forward-only). This is the gradient of csrc/ssd_scan.cu's y with respect to x, dtA, B
// and C (the final state takes none: training never asks for it). Per (b, h) and chunk c
// of Q steps, with Acs the inclusive cumsum of dtA, Λ = Acs_{Q-1}, e = exp(Acs),
// e' = exp(Λ - Acs), L[i][j] = exp(Acs_i - Acs_j) for j <= i (0 above the diagonal:
// the mask comes before the exp), G = C Bᵀ and dS = dy xᵀ:
//
//     s_c        the state at the chunk's start (from zero, as the forward)
//     g_c      = g_{c+1} · exp(Λ_c) + (dy ⊙ e)ᵀ C,  g_nc = 0   (the gradient of s_c)
//     dx       = (G ⊙ L)ᵀ dy + e' ⊙ (B g_{c+1}ᵀ)
//     dC_h     = (dS ⊙ L) B + e ⊙ (dy s_c)
//     dB_h     = (dS ⊙ L)ᵀ C + e' ⊙ (x g_{c+1})
//     dAcs     = rowsum(M) - colsum(M) + rowsum(dy ⊙ e ⊙ (C s_cᵀ)) - w,  M = dS ⊙ L ⊙ G,
//                w = rowsum(x ⊙ e' ⊙ (B g_{c+1}ᵀ));  dAcs_{Q-1} += Σ w + exp(Λ)·Σ(g_{c+1} ⊙ s_c)
//     d(dtA)   = the reverse cumsum of dAcs within the chunk;  dB, dC = Σ_h dB_h, dC_h
//
// Everything is f32 (x, dy, B and C widened on load), as the port's forward keeps L, the
// decays and the state in f32 (ROADMAP.md §3 fault 2: the JAX model's ssd_chunked
// rounds them to the activations' dtype; this kernel mirrors the port's forward). dx,
// dB and dC are rounded once to x's dtype; d(dtA) is written in f32.
//
// What bounds it on this card: at Mamba2-780M's training shape the bytes (x, dy, dx,
// dtA and its gradient, B, C, dB, dC once: ~163 MB, 0.049 ms at 3.35 TB/s) and the
// operations (~58 GFLOP, 0.059 ms at the bf16 tensor rate) are close. This first
// kernel runs every product as scalar FMAs on the f32 SIMT pipes and keeps f32 scratch
// in device memory; it is some 50x its bound, and making it fast is later work (the
// tensor cores, the states kept from the forward, no per-head partials).
//
// Three launches, on the stream given, all sized by the Python plan
// (kernels/ssd_scan.py:bwd_geometry), whose shared-memory sizes the launch checks:
//   * bwd_states_kernel, one block of 256 threads per (b, h): walks the chunks first to last,
//     writing each chunk's starting state s_c (f32, (B,H,nc,P,N)), then last to first,
//     writing g_{c+1} for each chunk (the same layout) and exp(Λ_c)·Σ(g_{c+1} ⊙ s_c).
//     The state, then its gradient, lives in the threads' registers (a thread owns the
//     same (p, n) entries in both walks, so it reads back only what it wrote);
//   * bwd_chunk_kernel, one block of 256 threads per (b, h, chunk), all in parallel: the
//     chunk's gradients from dy, s_c and g_{c+1}, in 32-row slabs of the (Q, Q)
//     matrices. A row pass (B, x and s_c resident; C and dy a slab at a time) finishes
//     dC_h, the row sums and rowsum(dy ⊙ e ⊙ (C s_cᵀ)); a column pass (C, dy and g_{c+1}
//     resident; B and x a slab at a time) finishes dx, dB_h and w. dB_h and dC_h go to
//     f32 per-head partials (B,H,L,N); dx and d(dtA) to their outputs;
//   * bwd_reduce_kernel sums the per-head partials over h in order into dB and dC.
// No atomics: every sum is taken in a fixed order (a thread's own loop, a warp's xor
// shuffles, one thread over the block's partials), so two calls on the same inputs give
// bit-equal outputs.
//
// Products are register-tiled: a warp owns rows (r + 8a for its warp index r) and a lane
// columns (lane + 32b), so the row operand is a broadcast read of shared memory and the
// column operand reads 32 consecutive columns or 32 rows of an odd stride (padded rows:
// no bank conflicts). Q is a runtime value from 1 to 128 (L % Q == 0 is the wrapper's
// check): rows past Q are zeros on load, masked in L and the decays, and never stored.
// At Q 128, N 128, P 64 the chunk kernel takes 193,040 bytes of shared memory and the
// scan kernel 101,392.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlab = 32;  // rows (row pass) or columns (column pass) of a (Q, Q) slab
constexpr int kMaxQ = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__host__ __device__ constexpr int pad_slab(int q) { return (q + kSlab - 1) / kSlab * kSlab; }

// Shared memory of each kernel, in floats, for a chunk of Q steps (Qp = Q rounded up to
// 32); kernels/ssd_scan.py:bwd_geometry computes the same and the launch checks it
template <int N, int P>
struct Plan {
    static constexpr int kLdN = N + 1;
    static constexpr int kLdP = P + 1;
    static __host__ __device__ int scan_floats(int Qp) {
        return Qp * kLdN + Qp * kLdP + 2 * Qp + kThreads + 4;
    }
    static __host__ __device__ int chunk_floats(int Qp) {
        return Qp * kLdN + Qp * kLdP + P * kLdN + kSlab * kLdN + kSlab * kLdP
               + 2 * Qp * (kSlab + 1) + 4 * Qp + 4;
    }
};

// rows [0, rows) of COLS elements (source row stride COLS) into f32 shared memory of row
// stride ld, rows [rows, rows_pad) zeroed
template <typename T, int COLS>
__device__ __forceinline__ void stage(float* dst, int ld, const T* __restrict__ src, int rows,
                                      int rows_pad) {
    for (int i = threadIdx.x; i < rows_pad * COLS; i += kThreads) {
        const int r = i / COLS;
        const int c = i % COLS;
        dst[r * ld + c] = r < rows ? to_f32(src[static_cast<size_t>(r) * COLS + c]) : 0.f;
    }
}

// acc[a][b] += Σ_{k0 <= k < k1} A[row·ar + k·ak] · Bv[col·bc + k·bk] for the warp's rows
// row = warp + 8a (a < RM) and the lane's columns col = lane + 32b (b < CN); a column at
// or past `cols` reads zero
template <int RM, int CN>
__device__ __forceinline__ void mac(float (&acc)[RM][CN], const float* A, int ar, int ak,
                                    const float* Bv, int bc, int bk, int k0, int k1, int cols) {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
#pragma unroll 2
    for (int k = k0; k < k1; ++k) {
        float a[RM], b[CN];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = A[(warp + kWarps * i) * ar + k * ak];
#pragma unroll
        for (int j = 0; j < CN; ++j) {
            const int col = lane + 32 * j;
            b[j] = col < cols ? Bv[col * bc + k * bk] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
}

template <int RM, int CN>
__device__ __forceinline__ void zero(float (&acc)[RM][CN]) {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// acs[0..Q) = the inclusive cumsum of the chunk's dtA (one thread, in order), lam = Λ;
// rows [Q, Qp) zero
__device__ __forceinline__ void chunk_cumsum(float* acs, float* lam, const float* __restrict__ a,
                                             int Q, int Qp) {
    for (int i = threadIdx.x; i < Qp; i += kThreads) acs[i] = i < Q ? a[i] : 0.f;
    __syncthreads();
    if (threadIdx.x == 0) {
        float run = 0.f;
        for (int i = 0; i < Q; ++i) {
            run += acs[i];
            acs[i] = run;
        }
        lam[0] = run;
    }
    __syncthreads();
}

// ---------------------------------------------------------------- the states and their gradients
template <typename T, int N, int P>
__global__ void __launch_bounds__(kThreads, 1)
bwd_states_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ dta,
            const T* __restrict__ bm, const T* __restrict__ cm, float* __restrict__ states,
            float* __restrict__ dstates, float* __restrict__ gs, int H, int L, int Q) {
    using Pl = Plan<N, P>;
    constexpr int kRM = P / kWarps;            // state rows a thread owns
    constexpr int kCN = (N + 31) / 32;         // state column groups a lane owns
    extern __shared__ float sm[];
    const int Qp = pad_slab(Q);
    float* mat = sm;                       // (Qp, N+1): B (first walk) or C (second)
    float* vec = mat + Qp * Pl::kLdN;      // (Qp, P+1): x ⊙ e' or dy ⊙ e
    float* acs = vec + Qp * Pl::kLdP;      // (Qp)
    float* wgt = acs + Qp;                 // (Qp): e' or e
    float* part = wgt + Qp;                // (kThreads)
    float* lam = part + kThreads;          // [0] = Λ
    const int h = blockIdx.x, b = blockIdx.y;
    const int nc = L / Q;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const size_t bh = static_cast<size_t>(b) * H + h;
    const T* xb = x + bh * L * P;
    const T* dyb = dy + bh * L * P;
    const float* ab = dta + bh * L;
    const T* Bb = bm + static_cast<size_t>(b) * L * N;
    const T* Cb = cm + static_cast<size_t>(b) * L * N;
    float* Sb = states + bh * nc * P * N;
    float* Gb = dstates + bh * nc * P * N;

    float acc[kRM][kCN];
    // first walk: s_{c+1} = s_c · exp(Λ) + (x ⊙ e')ᵀ B
    zero(acc);
    for (int c = 0; c < nc; ++c) {
        stage<T, N>(mat, Pl::kLdN, Bb + static_cast<size_t>(c) * Q * N, Q, Qp);
        stage<T, P>(vec, Pl::kLdP, xb + static_cast<size_t>(c) * Q * P, Q, Qp);
        chunk_cumsum(acs, lam, ab + c * Q, Q, Qp);
        const float L_ = lam[0];
        for (int j = threadIdx.x; j < Qp * P; j += kThreads) {
            const int r = j / P;
            vec[r * Pl::kLdP + j % P] *= r < Q ? expf(L_ - acs[r]) : 0.f;
        }
        float* out = Sb + static_cast<size_t>(c) * P * N;
        const float decay = expf(L_);
#pragma unroll
        for (int i = 0; i < kRM; ++i)
#pragma unroll
            for (int j = 0; j < kCN; ++j) {
                const int n = lane + 32 * j;
                if (n < N) out[(warp + kWarps * i) * N + n] = acc[i][j];
                acc[i][j] *= decay;
            }
        __syncthreads();
        mac(acc, vec, 1, Pl::kLdP, mat, 1, Pl::kLdN, 0, Q, N);
        __syncthreads();
    }
    // second walk, last chunk first: g_c = g_{c+1} · exp(Λ) + (dy ⊙ e)ᵀ C
    zero(acc);
    for (int c = nc - 1; c >= 0; --c) {
        float* out = Gb + static_cast<size_t>(c) * P * N;
        const float* sc = Sb + static_cast<size_t>(c) * P * N;
        float gsum = 0.f;
#pragma unroll
        for (int i = 0; i < kRM; ++i)
#pragma unroll
            for (int j = 0; j < kCN; ++j) {
                const int n = lane + 32 * j;
                if (n < N) {
                    const int at = (warp + kWarps * i) * N + n;
                    out[at] = acc[i][j];
                    gsum = fmaf(acc[i][j], sc[at], gsum);  // s_c as this thread wrote it
                }
            }
        part[threadIdx.x] = gsum;
        stage<T, N>(mat, Pl::kLdN, Cb + static_cast<size_t>(c) * Q * N, Q, Qp);
        stage<T, P>(vec, Pl::kLdP, dyb + static_cast<size_t>(c) * Q * P, Q, Qp);
        chunk_cumsum(acs, lam, ab + c * Q, Q, Qp);
        const float L_ = lam[0];
        for (int j = threadIdx.x; j < Qp * P; j += kThreads) {
            const int r = j / P;
            vec[r * Pl::kLdP + j % P] *= r < Q ? expf(acs[r]) : 0.f;
        }
        const float decay = expf(L_);
        if (threadIdx.x == 0) {
            float total = 0.f;
            for (int t = 0; t < kThreads; ++t) total += part[t];
            gs[bh * nc + c] = decay * total;
        }
#pragma unroll
        for (int i = 0; i < kRM; ++i)
#pragma unroll
            for (int j = 0; j < kCN; ++j) acc[i][j] *= decay;
        __syncthreads();
        mac(acc, vec, 1, Pl::kLdP, mat, 1, Pl::kLdN, 0, Q, N);
        __syncthreads();
    }
}

// ---------------------------------------------------------------- each chunk's gradients
template <typename T, int N, int P>
__global__ void __launch_bounds__(kThreads, 1)
bwd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ dta,
             const T* __restrict__ bm, const T* __restrict__ cm,
             const float* __restrict__ states, const float* __restrict__ dstates,
             const float* __restrict__ gs, T* __restrict__ dx, float* __restrict__ ddta,
             float* __restrict__ dbp, float* __restrict__ dcp, int H, int L, int Q) {
    using Pl = Plan<N, P>;
    constexpr int kLdN = Pl::kLdN, kLdP = Pl::kLdP;
    constexpr int kRM = kSlab / kWarps;       // 4 rows a thread
    constexpr int kCQ = kMaxQ / 32;           // column groups over the chunk
    constexpr int kCN = (N + 31) / 32;
    constexpr int kCP = (P + 31) / 32;
    constexpr int kLdT = kSlab + 1;           // the column pass's (Qp, 32) slabs
    extern __shared__ float sm[];
    const int Qp = pad_slab(Q);
    const int kLdS = Qp + 1;                  // the row pass's (32, Qp) slabs
    float* whole = sm;                        // (Qp, N+1): B (row pass), C (column pass)
    float* wv = whole + Qp * kLdN;            // (Qp, P+1): x, then dy
    float* st = wv + Qp * kLdP;               // (P, N+1): s_c, then g_{c+1}
    float* sl_n = st + P * kLdN;              // (32, N+1): a slab of C, then of B
    float* sl_p = sl_n + kSlab * kLdN;        // (32, P+1): a slab of dy, then of x
    float* s1 = sl_p + kSlab * kLdP;          // D ⊙ ... slabs, Qp·33 floats each
    float* s2 = s1 + Qp * kLdT;
    float* acs = s2 + Qp * kLdT;              // (Qp)
    float* drow = acs + Qp;                   // (Qp): rowsum(M) + the C s_cᵀ term
    float* dcol = drow + Qp;                  // (Qp): colsum(M)
    float* warr = dcol + Qp;                  // (Qp): w
    float* lam = warr + Qp;                   // [0] = Λ
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int nc = L / Q;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const size_t bh = static_cast<size_t>(b) * H + h;
    const size_t row0 = bh * L + static_cast<size_t>(c) * Q;  // the chunk's first (b, h) row
    const size_t brow0 = static_cast<size_t>(b) * L + static_cast<size_t>(c) * Q;
    const T* xc = x + row0 * P;
    const T* dyc = dy + row0 * P;
    const T* Bc = bm + brow0 * N;
    const T* Cc = cm + brow0 * N;
    const size_t state_at = (bh * nc + c) * static_cast<size_t>(P) * N;

    chunk_cumsum(acs, lam, dta + row0, Q, Qp);
    const float L_ = lam[0];
    for (int i = threadIdx.x; i < Qp; i += kThreads) dcol[i] = 0.f;

    // ---- row pass: B, x and s_c resident; C and dy a slab of 32 rows at a time
    stage<T, N>(whole, kLdN, Bc, Q, Qp);
    stage<T, P>(wv, kLdP, xc, Q, Qp);
    stage<float, N>(st, kLdN, states + state_at, P, P);
    for (int s = 0; s * kSlab < Q; ++s) {
        const int i0 = s * kSlab;
        const int rows = min(kSlab, Q - i0);
        const int kmax = min(Q, i0 + kSlab);  // the columns j <= i of these rows
        stage<T, N>(sl_n, kLdN, Cc + static_cast<size_t>(i0) * N, rows, kSlab);
        stage<T, P>(sl_p, kLdP, dyc + static_cast<size_t>(i0) * P, rows, kSlab);
        __syncthreads();
        {   // G and dS of the slab's rows, then D = dS ⊙ L and M = D ⊙ G
            float g[kRM][kCQ], d[kRM][kCQ];
            zero(g);
            zero(d);
            mac(g, sl_n, kLdN, 1, whole, kLdN, 1, 0, N, kmax);
            mac(d, sl_p, kLdP, 1, wv, kLdP, 1, 0, P, kmax);
#pragma unroll
            for (int a = 0; a < kRM; ++a) {
                const int r = warp + kWarps * a;
                const int i = i0 + r;
                float rsum = 0.f;
#pragma unroll
                for (int q = 0; q < kCQ; ++q) {
                    const int j = lane + 32 * q;
                    if (j >= kmax) continue;
                    const float l = (j <= i && i < Q) ? expf(acs[i] - acs[j]) : 0.f;
                    const float dv = d[a][q] * l;
                    const float mv = dv * g[a][q];
                    s1[r * kLdS + j] = dv;
                    s2[r * kLdS + j] = mv;
                    rsum += mv;
                }
                rsum = warp_sum(rsum);
                if (lane == 0 && i < Q) drow[i] = rsum;
            }
        }
        __syncthreads();
        for (int j = threadIdx.x; j < kmax; j += kThreads) {  // colsum(M) over these rows
            float csum = 0.f;
            for (int r = 0; r < kSlab; ++r) csum += s2[r * kLdS + j];
            dcol[j] += csum;
        }
        {   // dC_h = D B + e ⊙ (dy s_c)
            float acc[kRM][kCN], off[kRM][kCN];
            zero(acc);
            zero(off);
            mac(acc, s1, kLdS, 1, whole, 1, kLdN, 0, kmax, N);
            mac(off, sl_p, kLdP, 1, st, 1, kLdN, 0, P, N);
#pragma unroll
            for (int a = 0; a < kRM; ++a) {
                const int i = i0 + warp + kWarps * a;
                if (i >= Q) continue;
                const float e = expf(acs[i]);
                float* out = dcp + (row0 + i) * N;
#pragma unroll
                for (int q = 0; q < kCN; ++q) {
                    const int n = lane + 32 * q;
                    if (n < N) out[n] = acc[a][q] + e * off[a][q];
                }
            }
        }
        {   // rowsum(dy ⊙ e ⊙ (C s_cᵀ)): the decay exp(Acs) of y's state term
            float cs[kRM][kCP];
            zero(cs);
            mac(cs, sl_n, kLdN, 1, st, kLdN, 1, 0, N, P);
#pragma unroll
            for (int a = 0; a < kRM; ++a) {
                const int r = warp + kWarps * a;
                float v = 0.f;
#pragma unroll
                for (int q = 0; q < kCP; ++q) {
                    const int p = lane + 32 * q;
                    if (p < P) v = fmaf(cs[a][q], sl_p[r * kLdP + p], v);
                }
                v = warp_sum(v);
                if (lane == 0 && i0 + r < Q) drow[i0 + r] += expf(acs[i0 + r]) * v;
            }
        }
        __syncthreads();
    }

    // ---- column pass: C, dy and g_{c+1} resident; B and x a slab of 32 rows at a time
    stage<T, N>(whole, kLdN, Cc, Q, Qp);
    stage<T, P>(wv, kLdP, dyc, Q, Qp);
    stage<float, N>(st, kLdN, dstates + state_at, P, P);
    for (int s = 0; s * kSlab < Q; ++s) {
        const int j0 = s * kSlab;
        const int cols = min(kSlab, Q - j0);
        stage<T, N>(sl_n, kLdN, Bc + static_cast<size_t>(j0) * N, cols, kSlab);
        stage<T, P>(sl_p, kLdP, xc + static_cast<size_t>(j0) * P, cols, kSlab);
        __syncthreads();
        {   // Gᵀ and dSᵀ of the slab's columns j over the rows i >= j0:
            // s1 = (G ⊙ L) and s2 = (dS ⊙ L), stored (i, j - j0)
            float g[kRM][kCQ], d[kRM][kCQ];
            zero(g);
            zero(d);
            mac(g, sl_n, kLdN, 1, whole, kLdN, 1, 0, N, Q);
            mac(d, sl_p, kLdP, 1, wv, kLdP, 1, 0, P, Q);
#pragma unroll
            for (int a = 0; a < kRM; ++a) {
                const int r = warp + kWarps * a;
                const int j = j0 + r;
#pragma unroll
                for (int q = 0; q < kCQ; ++q) {
                    const int i = lane + 32 * q;
                    if (i >= Qp || i < j0) continue;
                    const float l = (j <= i && i < Q && j < Q) ? expf(acs[i] - acs[j]) : 0.f;
                    s1[i * kLdT + r] = g[a][q] * l;
                    s2[i * kLdT + r] = d[a][q] * l;
                }
            }
        }
        __syncthreads();
        {   // dx = (G ⊙ L)ᵀ dy + e' ⊙ (B g_{c+1}ᵀ), and w = rowsum(x ⊙ the second term)
            float acc[kRM][kCP], off[kRM][kCP];
            zero(acc);
            zero(off);
            mac(acc, s1, 1, kLdT, wv, 1, kLdP, j0, Q, P);
            mac(off, sl_n, kLdN, 1, st, kLdN, 1, 0, N, P);
#pragma unroll
            for (int a = 0; a < kRM; ++a) {
                const int r = warp + kWarps * a;
                const int j = j0 + r;
                const float ep = j < Q ? expf(L_ - acs[j]) : 0.f;
                float v = 0.f;
#pragma unroll
                for (int q = 0; q < kCP; ++q) {
                    const int p = lane + 32 * q;
                    if (p >= P) continue;
                    const float o = ep * off[a][q];
                    v = fmaf(sl_p[r * kLdP + p], o, v);
                    if (j < Q) store1(dx + (row0 + j) * P + p, acc[a][q] + o);
                }
                v = warp_sum(v);
                if (lane == 0 && j < Q) warr[j] = v;
            }
        }
        {   // dB_h = (dS ⊙ L)ᵀ C + e' ⊙ (x g_{c+1})
            float acc[kRM][kCN], off[kRM][kCN];
            zero(acc);
            zero(off);
            mac(acc, s2, 1, kLdT, whole, 1, kLdN, j0, Q, N);
            mac(off, sl_p, kLdP, 1, st, 1, kLdN, 0, P, N);
#pragma unroll
            for (int a = 0; a < kRM; ++a) {
                const int j = j0 + warp + kWarps * a;
                if (j >= Q) continue;
                const float ep = expf(L_ - acs[j]);
                float* out = dbp + (row0 + j) * N;
#pragma unroll
                for (int q = 0; q < kCN; ++q) {
                    const int n = lane + 32 * q;
                    if (n < N) out[n] = acc[a][q] + ep * off[a][q];
                }
            }
        }
        __syncthreads();
    }

    // ---- d(dtA): dAcs with the terms through Λ on the last step, then its reverse cumsum
    if (threadIdx.x == 0) {
        float w_total = 0.f;
        for (int i = 0; i < Q; ++i) w_total += warr[i];
        float run = 0.f;
        float* out = ddta + row0;
        for (int i = Q - 1; i >= 0; --i) {
            float d = drow[i] - dcol[i] - warr[i];
            if (i == Q - 1) d += w_total + gs[bh * nc + c];
            run += d;
            out[i] = run;
        }
    }
}

// ---------------------------------------------------------------- dB and dC over the heads
// grid (blocks over B·L·N, 2): y 0 sums dB's partials, y 1 dC's, each over h in order
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_reduce_kernel(const float* __restrict__ dbp, const float* __restrict__ dcp, T* __restrict__ db,
              T* __restrict__ dc, int H, long long per_batch, long long total) {
    const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (idx >= total) return;
    const float* parts = blockIdx.y == 0 ? dbp : dcp;
    const long long b = idx / per_batch;
    const float* src = parts + b * H * per_batch + idx % per_batch;
    float sum = 0.f;
    for (int h = 0; h < H; ++h) sum += src[static_cast<long long>(h) * per_batch];
    store1((blockIdx.y == 0 ? db : dc) + idx, sum);
}

template <typename T, int N, int P>
cudaError_t launch(const void* x, const void* dy, const float* dta, const void* bm,
                   const void* cm, void* dx, float* ddta, void* db, void* dc, float* states,
                   float* dstates, float* gs, float* dbp, float* dcp, int B, int H, int L,
                   int Q, int scan_bytes, int chunk_bytes, cudaStream_t stream) {
    const int Qp = pad_slab(Q);
    if (scan_bytes != Plan<N, P>::scan_floats(Qp) * 4 ||
        chunk_bytes != Plan<N, P>::chunk_floats(Qp) * 4)
        return cudaErrorInvalidValue;  // the Python plan and this source disagree
    const T* xt = static_cast<const T*>(x);
    const T* dyt = static_cast<const T*>(dy);
    const T* bt = static_cast<const T*>(bm);
    const T* ct = static_cast<const T*>(cm);
    cudaError_t err = cudaFuncSetAttribute(bwd_states_kernel<T, N, P>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           scan_bytes);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(bwd_chunk_kernel<T, N, P>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, chunk_bytes);
    if (err != cudaSuccess) return err;
    bwd_states_kernel<T, N, P><<<dim3(H, B), kThreads, scan_bytes, stream>>>(
        xt, dyt, dta, bt, ct, states, dstates, gs, H, L, Q);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bwd_chunk_kernel<T, N, P><<<dim3(L / Q, H, B), kThreads, chunk_bytes, stream>>>(
        xt, dyt, dta, bt, ct, states, dstates, gs, static_cast<T*>(dx), ddta, dbp, dcp, H, L, Q);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long per_batch = static_cast<long long>(L) * N;
    const long long total = per_batch * B;
    bwd_reduce_kernel<T><<<dim3(static_cast<unsigned>((total + kThreads - 1) / kThreads), 2),
                       kThreads, 0, stream>>>(dbp, dcp, static_cast<T*>(db),
                                              static_cast<T*>(dc), H, per_batch, total);
    return cudaGetLastError();
}

template <typename T, int P>
cudaError_t launch_n(const void* x, const void* dy, const float* dta, const void* bm,
                     const void* cm, void* dx, float* ddta, void* db, void* dc, float* states,
                     float* dstates, float* gs, float* dbp, float* dcp, int B, int H, int L,
                     int N, int Q, int scan_bytes, int chunk_bytes, cudaStream_t st) {
#define SSD_BWD_N(NN)                                                                     \
    case NN:                                                                              \
        return launch<T, NN, P>(x, dy, dta, bm, cm, dx, ddta, db, dc, states, dstates, gs, \
                                dbp, dcp, B, H, L, Q, scan_bytes, chunk_bytes, st);
    switch (N) {
        SSD_BWD_N(16)
        SSD_BWD_N(32)
        SSD_BWD_N(64)
        SSD_BWD_N(128)
        default: return cudaErrorInvalidValue;
    }
#undef SSD_BWD_N
}

template <typename T>
cudaError_t launch_p(const void* x, const void* dy, const float* dta, const void* bm,
                     const void* cm, void* dx, float* ddta, void* db, void* dc, float* states,
                     float* dstates, float* gs, float* dbp, float* dcp, int B, int H, int L,
                     int P, int N, int Q, int scan_bytes, int chunk_bytes, cudaStream_t st) {
    switch (P) {
        case 32: return launch_n<T, 32>(x, dy, dta, bm, cm, dx, ddta, db, dc, states, dstates,
                                        gs, dbp, dcp, B, H, L, N, Q, scan_bytes, chunk_bytes, st);
        case 64: return launch_n<T, 64>(x, dy, dta, bm, cm, dx, ddta, db, dc, states, dstates,
                                        gs, dbp, dcp, B, H, L, N, Q, scan_bytes, chunk_bytes, st);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// x, dy, dx (B,H,L,P) and bm, cm, db, dc (B,L,N) in one dtype (0 = float32, 2 = bfloat16),
// dta and ddta (B,H,L) f32, all contiguous. Scratch, f32, from the Python plan
// (kernels/ssd_scan.py:bwd_geometry): states and dstates (B,H,L/Q,P,N), gs (B,H,L/Q),
// dbp and dcp (B,H,L,N). P in {32, 64}, N in {16, 32, 64, 128}, 1 <= Q <= 128 and L a
// multiple of Q; slab must be 32 and the shared-memory sizes the plan's. Returns the
// cudaError_t of the launches (0 = cudaSuccess); cudaErrorInvalidValue for anything else.
extern "C" int ssd_scan_bwd_launch(const void* x, const void* dy, const void* dta,
                                   const void* bm, const void* cm, void* dx, void* ddta,
                                   void* db, void* dc, void* states, void* dstates, void* gs,
                                   void* dbp, void* dcp, int B, int H, int L, int P, int N,
                                   int Q, int slab, int scan_bytes, int chunk_bytes, int dtype,
                                   void* stream) {
    if (B <= 0 || H <= 0 || L <= 0) return cudaSuccess;
    if (slab != kSlab || Q < 1 || Q > kMaxQ || L % Q != 0) return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* a = static_cast<const float*>(dta);
    float* da = static_cast<float*>(ddta);
    float* s = static_cast<float*>(states);
    float* g = static_cast<float*>(dstates);
    float* w = static_cast<float*>(gs);
    float* pb = static_cast<float*>(dbp);
    float* pc = static_cast<float*>(dcp);
    switch (dtype) {
        case 0: return static_cast<int>(launch_p<float>(
            x, dy, a, bm, cm, dx, da, db, dc, s, g, w, pb, pc, B, H, L, P, N, Q, scan_bytes,
            chunk_bytes, st));
        case 2: return static_cast<int>(launch_p<__nv_bfloat16>(
            x, dy, a, bm, cm, dx, da, db, dc, s, g, w, pb, pc, B, H, L, P, N, Q, scan_bytes,
            chunk_bytes, st));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
