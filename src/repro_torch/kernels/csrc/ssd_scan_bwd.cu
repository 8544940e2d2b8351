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
// L, the decays, the states and their gradients are f32, as the port's forward keeps
// them (ROADMAP.md §3 fault 2: the JAX model's ssd_chunked rounds them to the
// activations' dtype; this kernel mirrors the port's forward). dx, dB and dC are rounded
// once to x's dtype; d(dtA) is written in f32. ssd_scan_bwd_launch dispatches by dtype.
//
// What bounds it on this card: at Mamba2-780M's training shape (x (4,48,2048,64), B/C
// (4,2048,128)) the bytes (x, dy, dx, dtA and its gradient, B, C, dB, dC once: ~163 MB,
// 0.049 ms at 3.35 TB/s) and the operations (~58 GFLOP, 0.059 ms at the bf16 tensor
// rate) are close.
//
// bfloat16: the tensor-core path (namespace tc), four launches, all sized by the Python
// plan (kernels/ssd_scan.py:bwd_geometry, its `tc` part; the launch checks its group and
// shared-memory sizes against LocalSmem's and ChunkSmem's):
//   * ssd_bwd_local_kernel, one block of 8 warps per (chunk, group of 8 heads, batch),
//     two blocks an SM: B and C staged once, x and dy a head at a time; each head's
//     chunk-local state products own = (x ⊙ e')ᵀ·B and inject = (dy ⊙ e)ᵀ·C on the TF32
//     tensor cores (mma.sync m16n8k8: the decayed x or dy rounded to TF32, as the
//     forward's state update; B, C exact) into f32 scratch (B,H,L/Q,P,N), and Λ. In
//     parallel over every chunk: the states leave the one-block-a-head walk;
//   * ssd_bwd_carry_kernel, elementwise, one thread per 8 entries of a (batch, head)'s
//     state: walks the chunks first to last writing s_c over own_c, then last to first
//     writing g_{c+1} over inject_c, with exp(Λ_c)·Σ(g_{c+1} ⊙ s_c) a warp's entries at a
//     time (the JAX reference's own structure, models/mamba.py:114-130);
//   * ssd_bwd_chunk_kernel, one block of 8 warps per (chunk, group of 8 heads, batch): B
//     and C staged once and G = C·Bᵀ computed once (bf16 mma.sync m16n8k16, f32 sums:
//     exact) and kept for all of the block's heads, where the f32 kernel recomputes it
//     per head and per pass. Per head (x and dy staged by cp.async; s_c, then g_{c+1},
//     in flight while the products that do not need them run): dS = dy·xᵀ on the
//     lower-triangle 16x16 tiles only, D = dS ⊙ L and the tiles' row and column sums of
//     M in f32; dC += e ⊙ (dy·s_c) + D·B; dB += Dᵀ·C + e' ⊙ (x·g_{c+1}); G ⊙ L;
//     dx = e' ⊙ (B·g_{c+1}ᵀ) + (G ⊙ L)ᵀ·dy with w; d(dtA), a step a thread, then a warp's
//     reverse scan. Warp w owns (row tile w, first half of the columns) and (row tile
//     RT - 1 - w, second half) of dC, dB and dx, which evens out the triangle; dC and dB
//     are summed over the group's heads in its accumulators, in head order: no per-head
//     partials. The f32 (Q, Q) operands D and G ⊙ L enter the bf16 mma as two terms,
//     hi = bf16(v) and lo = bf16(v - hi) (≲ 2^-17 relative; one term is not enough, as
//     the forward found), by ldmatrix (D for D·B) and ldmatrix.trans (Dᵀ, (G ⊙ L)ᵀ); s_c
//     and g_{c+1} enter the TF32 mma rounded to TF32 (≲ 2^-11 a term); x, dy, B and C
//     are exact; every sum is f32. dC and dB of the group go once, f32, to
//     (B, groups, L, N);
//   * bwd_reduce_kernel<bf16> sums the groups' partials in order and rounds once to bf16.
//   At Q 128, N 128, P 64 the chunk kernel takes 214,528 bytes of shared memory (one
//   block an SM; B, C 64 KiB, x, dy 32 KiB, G 36 KiB, the D or G ⊙ L tiles 36 KiB, the
//   state 33 KiB) and 255 registers a thread (its dC and dB accumulators are 128), so it
//   runs 8 warps an SM; the local kernel 99,840 bytes. The grids: 384 blocks at
//   Mamba2-780M's training shape, 512 at Zamba2-1.2B's, for 132 SMs. mma.sync rather
//   than wgmma: the (Q, Q) tiles with their diagonal masks fit its small fragments, as
//   in the forward. The scratch written and read back (the f32 states and their
//   gradients, and the groups' partials) is some 0.9 GB at Mamba2's shape.
//
// float32: three launches on the f32 SIMT pipes (on the tensor cores f32 would run as
// TF32 and miss the f32 tolerance), all sized by the Python plan, whose shared-memory
// sizes the launch checks:
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
//   * bwd_reduce_kernel<float> sums the per-head partials over h in order into dB and dC.
//   Products are register-tiled: a warp owns rows (r + 8a for its warp index r) and a
//   lane columns (lane + 32b), so the row operand is a broadcast read of shared memory
//   and the column operand reads 32 consecutive columns or 32 rows of an odd stride
//   (padded rows: no bank conflicts). At Q 128, N 128, P 64 the chunk kernel takes
//   193,040 bytes of shared memory and the scan kernel 101,392.
//
// Both paths: no two threads ever add into the same memory; every sum is taken in a fixed
// order (a thread's own loop, a warp's xor shuffles, one thread over the block's
// partials, the heads of a group in order, the groups in order), so two calls on the same
// inputs give bit-equal outputs.
// Q is a runtime value from 1 to 128 (L % Q == 0 is the wrapper's check): rows past Q
// are zeros on load, masked in L and the decays before any exp, and never stored.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#if defined(__CUDACC__) || defined(CUDA_EMU_MMA)
#include "mma_sync.cuh"  // mma.sync building blocks (shared with the forward)
#endif

namespace {

constexpr int kMaxQ = 128;

// ------------------------------------------------------------------ float32: SIMT
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlab = 32;  // rows (row pass) or columns (column pass) of a (Q, Q) slab

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
template <int COLS>
__device__ __forceinline__ void stage(float* dst, int ld, const float* __restrict__ src, int rows,
                                      int rows_pad) {
    for (int i = threadIdx.x; i < rows_pad * COLS; i += kThreads) {
        const int r = i / COLS;
        const int c = i % COLS;
        dst[r * ld + c] = r < rows ? src[static_cast<size_t>(r) * COLS + c] : 0.f;
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
template <int N, int P>
__global__ void __launch_bounds__(kThreads, 1)
bwd_states_kernel(const float* __restrict__ x, const float* __restrict__ dy, const float* __restrict__ dta,
            const float* __restrict__ bm, const float* __restrict__ cm, float* __restrict__ states,
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
    const float* xb = x + bh * L * P;
    const float* dyb = dy + bh * L * P;
    const float* ab = dta + bh * L;
    const float* Bb = bm + static_cast<size_t>(b) * L * N;
    const float* Cb = cm + static_cast<size_t>(b) * L * N;
    float* Sb = states + bh * nc * P * N;
    float* Gb = dstates + bh * nc * P * N;

    float acc[kRM][kCN];
    // first walk: s_{c+1} = s_c · exp(Λ) + (x ⊙ e')ᵀ B
    zero(acc);
    for (int c = 0; c < nc; ++c) {
        stage<N>(mat, Pl::kLdN, Bb + static_cast<size_t>(c) * Q * N, Q, Qp);
        stage<P>(vec, Pl::kLdP, xb + static_cast<size_t>(c) * Q * P, Q, Qp);
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
        stage<N>(mat, Pl::kLdN, Cb + static_cast<size_t>(c) * Q * N, Q, Qp);
        stage<P>(vec, Pl::kLdP, dyb + static_cast<size_t>(c) * Q * P, Q, Qp);
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
template <int N, int P>
__global__ void __launch_bounds__(kThreads, 1)
bwd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dy, const float* __restrict__ dta,
             const float* __restrict__ bm, const float* __restrict__ cm,
             const float* __restrict__ states, const float* __restrict__ dstates,
             const float* __restrict__ gs, float* __restrict__ dx, float* __restrict__ ddta,
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
    const float* xc = x + row0 * P;
    const float* dyc = dy + row0 * P;
    const float* Bc = bm + brow0 * N;
    const float* Cc = cm + brow0 * N;
    const size_t state_at = (bh * nc + c) * static_cast<size_t>(P) * N;

    chunk_cumsum(acs, lam, dta + row0, Q, Qp);
    const float L_ = lam[0];
    for (int i = threadIdx.x; i < Qp; i += kThreads) dcol[i] = 0.f;

    // ---- row pass: B, x and s_c resident; C and dy a slab of 32 rows at a time
    stage<N>(whole, kLdN, Bc, Q, Qp);
    stage<P>(wv, kLdP, xc, Q, Qp);
    stage<N>(st, kLdN, states + state_at, P, P);
    for (int s = 0; s * kSlab < Q; ++s) {
        const int i0 = s * kSlab;
        const int rows = min(kSlab, Q - i0);
        const int kmax = min(Q, i0 + kSlab);  // the columns j <= i of these rows
        stage<N>(sl_n, kLdN, Cc + static_cast<size_t>(i0) * N, rows, kSlab);
        stage<P>(sl_p, kLdP, dyc + static_cast<size_t>(i0) * P, rows, kSlab);
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
    stage<N>(whole, kLdN, Cc, Q, Qp);
    stage<P>(wv, kLdP, dyc, Q, Qp);
    stage<N>(st, kLdN, dstates + state_at, P, P);
    for (int s = 0; s * kSlab < Q; ++s) {
        const int j0 = s * kSlab;
        const int cols = min(kSlab, Q - j0);
        stage<N>(sl_n, kLdN, Bc + static_cast<size_t>(j0) * N, cols, kSlab);
        stage<P>(sl_p, kLdP, xc + static_cast<size_t>(j0) * P, cols, kSlab);
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
                    if (j < Q) dx[(row0 + j) * P + p] = acc[a][q] + o;
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
// grid (blocks over B·L·N, 2): y 0 sums dB's partials (B, parts, L, N), y 1 dC's, each over
// the parts in order (f32: the heads; bf16: the tensor-core kernels' groups of heads),
// rounded once to T
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_reduce_kernel(const float* __restrict__ dbp, const float* __restrict__ dcp, T* __restrict__ db,
                  T* __restrict__ dc, int parts, long long per_batch, long long total) {
    const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (idx >= total) return;
    const float* src = (blockIdx.y == 0 ? dbp : dcp) + idx / per_batch * parts * per_batch +
                       idx % per_batch;
    float sum = 0.f;
    for (int k = 0; k < parts; ++k) sum += src[static_cast<long long>(k) * per_batch];
    store1((blockIdx.y == 0 ? db : dc) + idx, sum);
}

template <int N, int P>
cudaError_t launch(const float* x, const float* dy, const float* dta, const float* bm,
                   const float* cm, float* dx, float* ddta, float* db, float* dc, float* states,
                   float* dstates, float* gs, float* dbp, float* dcp, int B, int H, int L,
                   int Q, int scan_bytes, int chunk_bytes, cudaStream_t stream) {
    const int Qp = pad_slab(Q);
    if (scan_bytes != Plan<N, P>::scan_floats(Qp) * 4 ||
        chunk_bytes != Plan<N, P>::chunk_floats(Qp) * 4)
        return cudaErrorInvalidValue;  // the Python plan and this source disagree
    cudaError_t err = cudaFuncSetAttribute(bwd_states_kernel<N, P>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           scan_bytes);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(bwd_chunk_kernel<N, P>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, chunk_bytes);
    if (err != cudaSuccess) return err;
    bwd_states_kernel<N, P><<<dim3(H, B), kThreads, scan_bytes, stream>>>(
        x, dy, dta, bm, cm, states, dstates, gs, H, L, Q);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bwd_chunk_kernel<N, P><<<dim3(L / Q, H, B), kThreads, chunk_bytes, stream>>>(
        x, dy, dta, bm, cm, states, dstates, gs, dx, ddta, dbp, dcp, H, L, Q);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long per_batch = static_cast<long long>(L) * N;
    const long long total = per_batch * B;
    bwd_reduce_kernel<float><<<dim3(static_cast<unsigned>((total + kThreads - 1) / kThreads), 2),
                              kThreads, 0, stream>>>(dbp, dcp, db, dc, H, per_batch, total);
    return cudaGetLastError();
}

template <int P>
cudaError_t launch_n(const float* x, const float* dy, const float* dta, const float* bm,
                     const float* cm, float* dx, float* ddta, float* db, float* dc, float* states,
                     float* dstates, float* gs, float* dbp, float* dcp, int B, int H, int L,
                     int N, int Q, int scan_bytes, int chunk_bytes, cudaStream_t st) {
#define SSD_BWD_N(NN)                                                                     \
    case NN:                                                                              \
        return launch<NN, P>(x, dy, dta, bm, cm, dx, ddta, db, dc, states, dstates, gs, \
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

cudaError_t launch_p(const float* x, const float* dy, const float* dta, const float* bm,
                     const float* cm, float* dx, float* ddta, float* db, float* dc, float* states,
                     float* dstates, float* gs, float* dbp, float* dcp, int B, int H, int L,
                     int P, int N, int Q, int scan_bytes, int chunk_bytes, cudaStream_t st) {
    switch (P) {
        case 32: return launch_n<32>(x, dy, dta, bm, cm, dx, ddta, db, dc, states, dstates,
                                     gs, dbp, dcp, B, H, L, N, Q, scan_bytes, chunk_bytes, st);
        case 64: return launch_n<64>(x, dy, dta, bm, cm, dx, ddta, db, dc, states, dstates,
                                     gs, dbp, dcp, B, H, L, N, Q, scan_bytes, chunk_bytes, st);
        default: return cudaErrorInvalidValue;
    }
}


// ------------------------------------------------------------------ bfloat16: tensor cores
// Built by nvcc, and by the CPU emulator (tests/cuda_emu), which supplies the warp-wide
// instructions; a plain g++ build without either compiles the f32 kernels alone.
#if defined(__CUDACC__) || defined(CUDA_EMU_MMA)
namespace tc {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 8;      // heads a local or chunk block takes
constexpr int kCarryVec = 8;   // state entries a carry thread owns

using namespace mma;  // mma_sync.cuh: mma.sync, ldmatrix, cp.async and the slab layout

__device__ __forceinline__ float as_f(uint32_t u) { return __uint_as_float(u); }
// (v0, v1) as two bf16 terms a pair: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi, uint32_t& lo) {
    hi = pack_bf16(v0, v1);
    lo = pack_bf16(v0 - as_f(lo_bits(hi)), v1 - as_f(hi_bits(hi)));
}

// warp 0: acs (the inclusive cumsum of the chunk's dtA), e_i = exp(acs_i) and
// e'_i = exp(Λ - acs_i) for i < Q, all three 0 past Q (Q <= 128): each lane sums four
// consecutive steps, then the lanes' totals are scanned with shuffles
__device__ __forceinline__ void chunk_vectors(float* acs, float* e, float* ep,
                                              const float* __restrict__ a, int Q) {
    const int lane = threadIdx.x % 32;
    float v[4];
    float run = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int i = lane * 4 + k;
        run += i < Q ? a[i] : 0.f;
        v[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    float mine = 0.f;  // acs_{Q-1} if this lane holds it
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        v[k] += excl;
        if (k == (Q - 1) % 4) mine = v[k];
    }
    const float last = __shfl_sync(0xffffffffu, mine, (Q - 1) / 4);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int i = lane * 4 + k;
        acs[i] = i < Q ? v[k] : 0.f;
        e[i] = i < Q ? expf(v[k]) : 0.f;
        ep[i] = i < Q ? expf(last - v[k]) : 0.f;
    }
}

// acc[u] += A (the warp's 16 rows of a bf16 slab, k = [0, K)) · S (f32, k rows of stride
// ld, columns n0 + 8u + [0, 8)), on the TF32 tensor cores: A is exact in TF32, S is
// rounded to it. The k index t of an m16n8k8 step is column 2t of the 8 it covers and
// t + 4 column 2t + 1, which is what a bf16 pair of an ldmatrix fragment holds.
template <int COLS, int K, int NU>
__device__ __forceinline__ void rows_times_state(float (&acc)[NU][4], const bf16* slab, int r0,
                                                 int Qp, const float* S, int ld, int n0) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int lr = (lane % 8) + ((lane / 8) % 2) * 8, lc = lane / 16;
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 16) {
        uint32_t a[4];
        ldsm_x4(a, slab + at<COLS>(r0 + lr, k0 + lc * 8, Qp));
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const uint32_t p0 = a[2 * half], p1 = a[2 * half + 1];
            const float* s0 = S + (k0 + 8 * half + 2 * t) * ld + n0 + g;
#pragma unroll
            for (int u = 0; u < NU; ++u)
                mma_tf32(acc[u], lo_bits(p0), lo_bits(p1), hi_bits(p0), hi_bits(p1),
                         tf32(s0[8 * u]), tf32(s0[ld + 8 * u]));
        }
    }
}

// Kernel 1: for each head of the group, the chunk's local state products
// own = (x ⊙ e')ᵀ·B and inject = (dy ⊙ e)ᵀ·C (P, N) f32, and Λ. One block per (chunk,
// group of heads, batch): B and C staged once, x and dy a head at a time (cp.async).
// Warps 0-3 take own, 4-7 inject; each a 16-row tile of P and a share of the N columns.
// The decayed x (dy) is rounded to TF32 (as the forward's state update); B and C are
// exact.
template <int N, int P>
struct LocalSmem {
    static __host__ __device__ int bytes(int Qp) {
        return 2 * Qp * N * 2 + 2 * Qp * P * 2 + 3 * kMaxQ * 4;
    }
};

template <int N, int P>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_local_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                     const float* __restrict__ dta, const bf16* __restrict__ bm,
                     const bf16* __restrict__ cm, float* __restrict__ own,
                     float* __restrict__ inject, float* __restrict__ lam, int H, int L, int Q) {
    extern __shared__ float sm[];
    constexpr int kPT = P / 16;                          // 16-row tiles of the state
    constexpr int kSplit = 4 / kPT;                      // warps sharing a tile's columns
    constexpr int kNT = N / 8;
    constexpr int kNTW = (kNT + kSplit - 1) / kSplit;    // 8-column tiles a warp takes
    const int Qp = (Q + 15) / 16 * 16;
    bf16* Bs = reinterpret_cast<bf16*>(sm);
    bf16* Cs = Bs + Qp * N;
    bf16* Xs = Cs + Qp * N;
    bf16* Ys = Xs + Qp * P;
    float* acs = reinterpret_cast<float*>(Ys + Qp * P);
    float* e = acs + kMaxQ;
    float* ep = e + kMaxQ;
    const int c = blockIdx.x, b = blockIdx.z;
    const int h0 = blockIdx.y * kGroup, h1 = min(H, h0 + kGroup);
    const int nc = L / Q;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const bool inj = warp >= 4;
    const int sp0 = ((warp % 4) % kPT) * 16;
    const int sn0 = ((warp % 4) / kPT) * kNTW;
    const size_t brow0 = static_cast<size_t>(b) * L + static_cast<size_t>(c) * Q;
    stage_rows<N>(Bs, bm + brow0 * N, Q, Qp);
    stage_rows<N>(Cs, cm + brow0 * N, Q, Qp);
    for (int h = h0; h < h1; ++h) {
        const size_t bh = static_cast<size_t>(b) * H + h;
        const size_t row0 = bh * L + static_cast<size_t>(c) * Q;
        __syncthreads();  // the previous head is done with x, dy and the vectors
        stage_rows<P>(Xs, x + row0 * P, Q, Qp);
        stage_rows<P>(Ys, dy + row0 * P, Q, Qp);
        cp_commit();
        if (warp == 0) chunk_vectors(acs, e, ep, dta + row0, Q);
        cp_wait<0>();
        __syncthreads();
        if (threadIdx.x == 0) lam[bh * nc + c] = acs[Q - 1];
        const bf16* vs = inj ? Ys : Xs;
        const bf16* ms = inj ? Cs : Bs;
        const float* wv = inj ? e : ep;
        float acc[kNTW][4];
#pragma unroll
        for (int u = 0; u < kNTW; ++u)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[u][k] = 0.f;
        if (sn0 < kNT) {
            for (int j0 = 0; j0 < Qp; j0 += 16) {
                // A = (v ⊙ w)ᵀ: columns sp0.. of rows j0.. of the slab, by ldmatrix.trans
                // (rows 2t and 2t + 1 of one column, packed), scaled and rounded to TF32
                uint32_t xf[4];
                ldsm_x4_t(xf, vs + at<P>(j0 + (lane / 16) * 8 + lane % 8,
                                         sp0 + ((lane / 8) % 2) * 8, Qp));
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int ja = j0 + 8 * half + 2 * t;
                    const float da = wv[ja], db = wv[ja + 1];
                    const uint32_t lo = xf[2 * half], hi = xf[2 * half + 1];
                    const uint32_t a0 = tf32(as_f(lo_bits(lo)) * da);
                    const uint32_t a2 = tf32(as_f(hi_bits(lo)) * db);
                    const uint32_t a1 = tf32(as_f(lo_bits(hi)) * da);
                    const uint32_t a3 = tf32(as_f(hi_bits(hi)) * db);
                    const int jrow = j0 + 8 * half + lane % 8;
                    // B = the matrix's rows ja, ja + 1 of column n, by ldmatrix.trans
#pragma unroll
                    for (int u = 0; u < kNTW; u += (kNTW >= 4 ? 4 : kNTW)) {
                        if constexpr (kNTW >= 4) {
                            uint32_t bf[4];
                            ldsm_x4_t(bf, ms + at<N>(jrow, (sn0 + u + lane / 8) * 8, Qp));
#pragma unroll
                            for (int v = 0; v < 4; ++v)
                                mma_tf32(acc[u + v], a0, a1, a2, a3, lo_bits(bf[v]),
                                         hi_bits(bf[v]));
                        } else if constexpr (kNTW == 2) {
                            uint32_t bf[2];
                            ldsm_x2_t(bf, ms + at<N>(jrow, (sn0 + (lane / 8) % 2) * 8, Qp));
                            mma_tf32(acc[0], a0, a1, a2, a3, lo_bits(bf[0]), hi_bits(bf[0]));
                            mma_tf32(acc[1], a0, a1, a2, a3, lo_bits(bf[1]), hi_bits(bf[1]));
                        } else {
                            uint32_t bf;
                            ldsm_x1_t(bf, ms + at<N>(jrow, sn0 * 8, Qp));
                            mma_tf32(acc[0], a0, a1, a2, a3, lo_bits(bf), hi_bits(bf));
                        }
                    }
                }
            }
            float* out = (inj ? inject : own) + (bh * nc + c) * static_cast<size_t>(P) * N;
#pragma unroll
            for (int u = 0; u < kNTW; ++u) {
                const int col = (sn0 + u) * 8 + 2 * t;
                *reinterpret_cast<float2*>(out + (sp0 + g) * N + col) =
                    make_float2(acc[u][0], acc[u][1]);
                *reinterpret_cast<float2*>(out + (sp0 + g + 8) * N + col) =
                    make_float2(acc[u][2], acc[u][3]);
            }
        }
    }
}

// Kernel 2: the states carried across the chunks, elementwise, one thread per kCarryVec
// entries of a (batch, head)'s (P, N) state (two float4s, a block's threads apart),
// walking the chunks first to last (s_{c+1} = s_c · exp(Λ_c) + own_c, s_c written over
// own_c) and last to first
// (g_c = g_{c+1} · exp(Λ_c) + inject_c, g_{c+1} written over inject_c), the next chunk's
// entries loaded while this one's are stored. exp(Λ_c)·Σ(g_{c+1} ⊙ s_c) over a warp's
// entries (xor shuffles) goes to gs_part (B, H, parts, nc), one part a warp, which
// ssd_bwd_chunk_kernel sums in order.
template <int PN>
struct Carry {  // for a state of PN = P·N entries
    static constexpr int kThreads = PN / kCarryVec < tc::kThreads ? PN / kCarryVec : tc::kThreads;
    static constexpr int kSlices = PN / (kThreads * kCarryVec);  // blocks a (batch, head)
    static constexpr int kParts = kSlices * (kThreads / 32);
};

__device__ __forceinline__ float4 fma4(float4 v, float d, float4 o) {
    return float4{fmaf(v.x, d, o.x), fmaf(v.y, d, o.y), fmaf(v.z, d, o.z), fmaf(v.w, d, o.w)};
}

template <int PN>
__global__ void __launch_bounds__(Carry<PN>::kThreads)
ssd_bwd_carry_kernel(float* __restrict__ states, float* __restrict__ dstates,
                     const float* __restrict__ lam, float* __restrict__ gs_part, int H, int nc) {
    using C = Carry<PN>;
    constexpr int kStep = PN / 4;  // float4s a chunk
    const int slice = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int lane = threadIdx.x % 32;
    const size_t bh = static_cast<size_t>(b) * H + h;
    // the thread's entries: float4s t and t + kThreads of its block's slice (coalesced)
    const size_t at0 = bh * nc * kStep + slice * 2 * C::kThreads + threadIdx.x;
    float4* S = reinterpret_cast<float4*>(states) + at0;
    float4* G = reinterpret_cast<float4*>(dstates) + at0;
    constexpr int kT = C::kThreads;
    const float* lm = lam + bh * nc;
    const int part = slice * (C::kThreads / 32) + threadIdx.x / 32;  // one a warp
    float* part_out = gs_part + (bh * C::kParts + part) * nc;
    float4 v0{0.f, 0.f, 0.f, 0.f}, v1{0.f, 0.f, 0.f, 0.f};
    float4 n0 = S[0], n1 = S[kT];
    for (int c = 0; c < nc; ++c) {
        const float4 o0 = n0, o1 = n1;
        if (c + 1 < nc) {
            n0 = S[(c + 1) * kStep];
            n1 = S[(c + 1) * kStep + kT];
        }
        S[c * kStep] = v0;
        S[c * kStep + kT] = v1;
        const float d = expf(lm[c]);
        v0 = fma4(v0, d, o0);
        v1 = fma4(v1, d, o1);
    }
    v0 = v1 = float4{0.f, 0.f, 0.f, 0.f};
    float4 i0 = G[(nc - 1) * kStep], i1 = G[(nc - 1) * kStep + kT];
    float4 s0 = S[(nc - 1) * kStep], s1 = S[(nc - 1) * kStep + kT];
    for (int c = nc - 1; c >= 0; --c) {
        const float4 a0 = i0, a1 = i1, b0 = s0, b1 = s1;
        if (c > 0) {
            i0 = G[(c - 1) * kStep];
            i1 = G[(c - 1) * kStep + kT];
            s0 = S[(c - 1) * kStep];
            s1 = S[(c - 1) * kStep + kT];
        }
        G[c * kStep] = v0;
        G[c * kStep + kT] = v1;
        float part = v0.x * b0.x;
        part = fmaf(v0.y, b0.y, part);
        part = fmaf(v0.z, b0.z, part);
        part = fmaf(v0.w, b0.w, part);
        part = fmaf(v1.x, b1.x, part);
        part = fmaf(v1.y, b1.y, part);
        part = fmaf(v1.z, b1.z, part);
        part = fmaf(v1.w, b1.w, part);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        const float d = expf(lm[c]);
        if (lane == 0) part_out[c] = d * part;
        v0 = fma4(v0, d, a0);
        v1 = fma4(v1, d, a1);
    }
}

// Kernel 3's shared memory, in bytes, for a chunk padded to Qp rows (RT = Qp / 16 row
// tiles, T = RT(RT + 1) / 2 tiles of the (Q, Q) lower triangle): B, C (Qp, N) and x, dy
// (Qp, P) bf16 slabs | G f32, the T tiles in the order of the mma accumulators (a lane's
// 8 values together) | D or G ⊙ L as two bf16 terms, hi tiles then lo tiles, each
// (16, 16) with its rows' two 16-byte halves swizzled | the state or its gradient, f32
// (P, N + 4) | acs, e, e', two halves of the state's row sums, two halves of w and dAcs
// (kMaxQ f32 each) | the tiles' row and column sums of M (T × 16 f32 each)
template <int N, int P>
struct ChunkSmem {
    // rows 4 banks apart: a warp's reads of rows 2t, 2t + 1 and columns g are free of conflicts
    static constexpr int kLdS = N + 4;
    static __host__ __device__ int tiles(int Qp) { return (Qp / 16) * (Qp / 16 + 1) / 2; }
    static __host__ __device__ int g_off(int Qp) { return 2 * Qp * N * 2 + 2 * Qp * P * 2; }
    static __host__ __device__ int r_off(int Qp) { return g_off(Qp) + tiles(Qp) * 256 * 4; }
    static __host__ __device__ int s_off(int Qp) { return r_off(Qp) + tiles(Qp) * 256 * 2 * 2; }
    static __host__ __device__ int v_off(int Qp) { return s_off(Qp) + P * kLdS * 4; }
    static __host__ __device__ int bytes(int Qp) {
        return v_off(Qp) + 8 * kMaxQ * 4 + 2 * tiles(Qp) * 16 * 4;
    }
};

// (I, J) of lower-triangle tile τ = I(I + 1)/2 + J, J <= I
__device__ __forceinline__ void tile_ij(int tau, int& I, int& J) {
    I = 0;
    while ((I + 1) * (I + 2) / 2 <= tau) ++I;
    J = tau - I * (I + 1) / 2;
}
// bf16 element (r, c) of tile τ in the hi or lo array: the swizzle of the forward's
// G ⊙ L tiles (rows 4-7 of each 8 take the other 16-byte half first)
__device__ __forceinline__ int tile_at(int tau, int r, int c) {
    return tau * 256 + r * 16 + ((c / 8) ^ ((r / 4) & 1)) * 8 + c % 8;
}

// the 16x16 product of 16 rows of slab `a` (rows ra..) and 16 rows of slab `b` (rows
// rb..) over K columns: acc0 columns rb..rb+7, acc1 rb+8..rb+15 (bf16, f32 sums: exact
// products)
template <int COLS>
__device__ __forceinline__ void rows_by_rows(float (&acc0)[4], float (&acc1)[4], const bf16* a,
                                             int ra, const bf16* b, int rb, int Qp) {
    const int lane = threadIdx.x % 32;
    const int lr = (lane % 8) + ((lane / 8) % 2) * 8, lc = lane / 16;
#pragma unroll
    for (int k = 0; k < 4; ++k) acc0[k] = acc1[k] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < COLS; k0 += 16) {
        uint32_t af[4], bq[4];
        ldsm_x4(af, a + at<COLS>(ra + lr, k0 + lc * 8, Qp));
        ldsm_x4(bq, b + at<COLS>(rb + lr, k0 + lc * 8, Qp));
        mma_bf16(acc0, af, bq[0], bq[2]);
        mma_bf16(acc1, af, bq[1], bq[3]);
    }
}

// Kernel 3: each chunk's gradients, one block per (chunk, group of heads, batch). The
// block stages B and C once and computes G = C·Bᵀ once for all of its heads; then per
// head: dS = dy·xᵀ over the lower-triangle tiles, D = dS ⊙ L and the row and column sums
// of M = D ⊙ G; dC += e ⊙ (dy·s) + D·B; dB += Dᵀ·C + e' ⊙ (x·g); G ⊙ L;
// dx = e' ⊙ (B·gᵀ) + (G ⊙ L)ᵀ·dy with w; d(dtA). A warp owns two items of each of dC, dB
// and dx: (row tile w, the first half of the columns) and (row tile RT - 1 - w, the
// second half), which evens out the triangle; dC and dB are summed over the group's
// heads in order in its accumulators and written once, f32, to the group's partials.
template <int N, int P>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chunk_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                     const float* __restrict__ dta, const bf16* __restrict__ bm,
                     const bf16* __restrict__ cm, const float* __restrict__ states,
                     const float* __restrict__ dstates, const float* __restrict__ gs_part,
                     bf16* __restrict__ dx, float* __restrict__ ddta, float* __restrict__ dbp,
                     float* __restrict__ dcp, int H, int L, int Q) {
    using Sm = ChunkSmem<N, P>;
    constexpr int kLdS = Sm::kLdS;
    constexpr int kNH = N / 16;                // 8-column tiles of half of dB's and dC's N
    constexpr int kCh = kNH < 4 ? kNH : 4;     // of them a state product takes at once
    constexpr int kXN = P / 16;                // 8-column tiles of half of dx's P
    constexpr int kParts = Carry<P * N>::kParts;
    extern __shared__ float sm[];
    unsigned char* base = reinterpret_cast<unsigned char*>(sm);
    const int Qp = (Q + 15) / 16 * 16;
    const int RT = Qp / 16;
    const int T = Sm::tiles(Qp);
    bf16* Bs = reinterpret_cast<bf16*>(base);
    bf16* Cs = Bs + Qp * N;
    bf16* Xs = Cs + Qp * N;
    bf16* Ys = Xs + Qp * P;
    float* Gf = reinterpret_cast<float*>(base + Sm::g_off(Qp));
    bf16* Rh = reinterpret_cast<bf16*>(base + Sm::r_off(Qp));
    bf16* Rl = Rh + T * 256;
    float* S = reinterpret_cast<float*>(base + Sm::s_off(Qp));
    float* acs = reinterpret_cast<float*>(base + Sm::v_off(Qp));
    float* e = acs + kMaxQ;
    float* ep = e + kMaxQ;
    float* drs = ep + kMaxQ;         // (2, kMaxQ): e_i Σ_n C_in (dy·s)_in by column half
    float* wh = drs + 2 * kMaxQ;     // (2, kMaxQ): w by column half of dx
    float* dac = wh + 2 * kMaxQ;     // (kMaxQ): dAcs
    float* rsum = dac + kMaxQ;       // (T, 16): each tile's row sums of M
    float* csum = rsum + T * 16;     // (T, 16): and column sums

    const int c = blockIdx.x, gi = blockIdx.y, b = blockIdx.z;
    const int h0 = gi * kGroup, h1 = min(H, h0 + kGroup);
    const int nc = L / Q;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int lr = (lane % 8) + ((lane / 8) % 2) * 8, lc = lane / 16;   // ldmatrix: A rows
    const int tr = (lane % 8) + (lane / 16) * 8, tc_ = (lane / 8) % 2;  // ldmatrix.trans: Aᵀ
    const size_t brow0 = static_cast<size_t>(b) * L + static_cast<size_t>(c) * Q;
    const bool owner = warp < RT;
    // the warp's items: row tile it[half] of column half `half`
    const int it[2] = {warp, RT - 1 - warp};

    stage_rows<N>(Bs, bm + brow0 * N, Q, Qp);
    stage_rows<N>(Cs, cm + brow0 * N, Q, Qp);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    // G = C·Bᵀ, once for the block's heads, the lower-triangle tiles
    for (int tau = warp; tau < T; tau += kWarps) {
        int I, J;
        tile_ij(tau, I, J);
        float d0[4], d1[4];
        rows_by_rows<N>(d0, d1, Cs, I * 16, Bs, J * 16, Qp);
        float4* out = reinterpret_cast<float4*>(Gf + tau * 256 + lane * 8);
        out[0] = float4{d0[0], d0[1], d0[2], d0[3]};
        out[1] = float4{d1[0], d1[1], d1[2], d1[3]};
    }

    // dC and dB of the warp's two items, summed over the heads
    float accC[2][kNH][4], accB[2][kNH][4];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int u = 0; u < kNH; ++u)
#pragma unroll
            for (int k = 0; k < 4; ++k) accC[hf][u][k] = accB[hf][u][k] = 0.f;

    // (P, N) f32 state rows into S, row stride kLdS, as one cp.async group
    auto stage_state = [&](const float* src) {
        for (int i = threadIdx.x; i < P * (N / 4); i += kThreads) {
            const int r = i / (N / 4), c4 = i % (N / 4);
            cp16(S + r * kLdS + c4 * 4, src + r * N + c4 * 4);
        }
        cp_commit();
    };
    // acc[u] += D·M over K tiles: D tile (I, J) as hi + lo by ldmatrix (rows I, k = J),
    // or its transpose (rows J, k = I) by ldmatrix.trans; M's rows k, columns n0 + 8u.. by
    // ldmatrix.trans
    auto tiles_times = [&](float (&acc)[kNH][4], int tau, bool trans, const bf16* M, int k0,
                           int n0) {
        uint32_t ah[4], al[4];
        if (trans) {
            ldsm_x4_t(ah, Rh + tile_at(tau, tr, tc_ * 8));
            ldsm_x4_t(al, Rl + tile_at(tau, tr, tc_ * 8));
        } else {
            ldsm_x4(ah, Rh + tile_at(tau, lr, lc * 8));
            ldsm_x4(al, Rl + tile_at(tau, lr, lc * 8));
        }
        if constexpr (kNH >= 2) {
#pragma unroll
            for (int np = 0; np < kNH / 2; ++np) {
                uint32_t bq[4];
                ldsm_x4_t(bq, M + at<N>(k0 + lr, n0 + (2 * np + lc) * 8, Qp));
                mma_bf16(acc[2 * np], ah, bq[0], bq[1]);
                mma_bf16(acc[2 * np], al, bq[0], bq[1]);
                mma_bf16(acc[2 * np + 1], ah, bq[2], bq[3]);
                mma_bf16(acc[2 * np + 1], al, bq[2], bq[3]);
            }
        } else {
            uint32_t bq[2];
            ldsm_x2_t(bq, M + at<N>(k0 + lr, n0, Qp));
            mma_bf16(acc[0], ah, bq[0], bq[1]);
            mma_bf16(acc[0], al, bq[0], bq[1]);
        }
    };

    for (int h = h0; h < h1; ++h) {
        const size_t bh = static_cast<size_t>(b) * H + h;
        const size_t row0 = bh * L + static_cast<size_t>(c) * Q;
        const size_t state_at = (bh * nc + c) * static_cast<size_t>(P) * N;
        __syncthreads();  // the previous head is done with x, dy, S, the tiles and the vectors
        stage_rows<P>(Xs, x + row0 * P, Q, Qp);
        stage_rows<P>(Ys, dy + row0 * P, Q, Qp);
        cp_commit();
        stage_state(states + state_at);  // s_c, in flight during (1)
        if (warp == 0) chunk_vectors(acs, e, ep, dta + row0, Q);
        cp_wait<1>();  // x and dy
        __syncthreads();

        // (1) dS = dy·xᵀ, D = dS ⊙ L (the mask before the exp) into the tiles as hi + lo,
        // and the tile's row and column sums of M = D ⊙ G
        for (int tau = warp; tau < T; tau += kWarps) {
            int I, J;
            tile_ij(tau, I, J);
            float d[2][4];
            rows_by_rows<P>(d[0], d[1], Ys, I * 16, Xs, J * 16, Qp);
            const float4* gp = reinterpret_cast<const float4*>(Gf + tau * 256 + lane * 8);
            const float4 ga = gp[0], gb = gp[1];
            const float gv[2][4] = {{ga.x, ga.y, ga.z, ga.w}, {gb.x, gb.y, gb.z, gb.w}};
            float rs[2] = {0.f, 0.f}, cs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
            for (int s = 0; s < 2; ++s) {
                float dv[4];
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int i = I * 16 + g + 8 * (k / 2), j = J * 16 + 8 * s + 2 * t + k % 2;
                    const float l = (j <= i && i < Q) ? expf(acs[i] - acs[j]) : 0.f;
                    dv[k] = d[s][k] * l;
                    const float m = dv[k] * gv[s][k];
                    rs[k / 2] += m;
                    cs[s][k % 2] += m;
                }
                uint32_t hi, lo;
                const int c0 = 8 * s + 2 * t;
                split(dv[0], dv[1], hi, lo);
                *reinterpret_cast<uint32_t*>(Rh + tile_at(tau, g, c0)) = hi;
                *reinterpret_cast<uint32_t*>(Rl + tile_at(tau, g, c0)) = lo;
                split(dv[2], dv[3], hi, lo);
                *reinterpret_cast<uint32_t*>(Rh + tile_at(tau, g + 8, c0)) = hi;
                *reinterpret_cast<uint32_t*>(Rl + tile_at(tau, g + 8, c0)) = lo;
            }
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                rs[k] += __shfl_xor_sync(0xffffffffu, rs[k], 1);
                rs[k] += __shfl_xor_sync(0xffffffffu, rs[k], 2);
            }
#pragma unroll
            for (int s = 0; s < 2; ++s)
#pragma unroll
                for (int k = 0; k < 2; ++k)
#pragma unroll
                    for (int off = 4; off < 32; off <<= 1)
                        cs[s][k] += __shfl_xor_sync(0xffffffffu, cs[s][k], off);
            if (t == 0) {
                rsum[tau * 16 + g] = rs[0];
                rsum[tau * 16 + g + 8] = rs[1];
            }
            if (g == 0) {
#pragma unroll
                for (int s = 0; s < 2; ++s) {
                    csum[tau * 16 + 8 * s + 2 * t] = cs[s][0];
                    csum[tau * 16 + 8 * s + 2 * t + 1] = cs[s][1];
                }
            }
        }
        cp_wait<0>();  // s_c
        __syncthreads();

        // (2) dC of the warp's items += e ⊙ (dy·s) (with its row sums against C) + D·B
        if (owner) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int I = it[hf];
                const int i0 = I * 16 + g, i1 = i0 + 8;
                float r0 = 0.f, r1 = 0.f;
#pragma unroll
                for (int nb = 0; nb < kNH / kCh; ++nb) {
                    const int n0 = hf * (N / 2) + nb * kCh * 8;
                    float tmp[kCh][4];
#pragma unroll
                    for (int u = 0; u < kCh; ++u)
#pragma unroll
                        for (int k = 0; k < 4; ++k) tmp[u][k] = 0.f;
                    rows_times_state<P, P, kCh>(tmp, Ys, I * 16, Qp, S, kLdS, n0);
#pragma unroll
                    for (int u = 0; u < kCh; ++u) {
                        const int n = n0 + u * 8 + 2 * t;
                        const uint32_t c0 =
                            *reinterpret_cast<const uint32_t*>(Cs + at<N>(i0, n, Qp));
                        const uint32_t c1 =
                            *reinterpret_cast<const uint32_t*>(Cs + at<N>(i1, n, Qp));
                        r0 = fmaf(as_f(lo_bits(c0)), tmp[u][0], r0);
                        r0 = fmaf(as_f(hi_bits(c0)), tmp[u][1], r0);
                        r1 = fmaf(as_f(lo_bits(c1)), tmp[u][2], r1);
                        r1 = fmaf(as_f(hi_bits(c1)), tmp[u][3], r1);
                        float* a = accC[hf][nb * kCh + u];
                        a[0] = fmaf(e[i0], tmp[u][0], a[0]);
                        a[1] = fmaf(e[i0], tmp[u][1], a[1]);
                        a[2] = fmaf(e[i1], tmp[u][2], a[2]);
                        a[3] = fmaf(e[i1], tmp[u][3], a[3]);
                    }
                }
                r0 += __shfl_xor_sync(0xffffffffu, r0, 1);
                r0 += __shfl_xor_sync(0xffffffffu, r0, 2);
                r1 += __shfl_xor_sync(0xffffffffu, r1, 1);
                r1 += __shfl_xor_sync(0xffffffffu, r1, 2);
                if (t == 0) {
                    drs[hf * kMaxQ + i0] = e[i0] * r0;
                    drs[hf * kMaxQ + i1] = e[i1] * r1;
                }
                for (int J = 0; J <= I; ++J)
                    tiles_times(accC[hf], I * (I + 1) / 2 + J, false, Bs, J * 16, hf * (N / 2));
            }
        }
        __syncthreads();  // S is free
        stage_state(dstates + state_at);  // g_{c+1}, in flight during Dᵀ·C

        // (3) dB of the warp's items += Dᵀ·C, then (once g_{c+1} is in) e' ⊙ (x·g)
        if (owner) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int J = it[hf];
                for (int I = J; I < RT; ++I)
                    tiles_times(accB[hf], I * (I + 1) / 2 + J, true, Cs, I * 16, hf * (N / 2));
            }
        }
        cp_wait<0>();
        __syncthreads();  // g_{c+1} is in; the tiles of D are read
        if (owner) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int J = it[hf];
                const int j0 = J * 16 + g, j1 = j0 + 8;
#pragma unroll
                for (int nb = 0; nb < kNH / kCh; ++nb) {
                    float tmp[kCh][4];
#pragma unroll
                    for (int u = 0; u < kCh; ++u)
#pragma unroll
                        for (int k = 0; k < 4; ++k) tmp[u][k] = 0.f;
                    rows_times_state<P, P, kCh>(tmp, Xs, J * 16, Qp, S, kLdS,
                                                hf * (N / 2) + nb * kCh * 8);
#pragma unroll
                    for (int u = 0; u < kCh; ++u) {
                        float* a = accB[hf][nb * kCh + u];
                        a[0] = fmaf(ep[j0], tmp[u][0], a[0]);
                        a[1] = fmaf(ep[j0], tmp[u][1], a[1]);
                        a[2] = fmaf(ep[j1], tmp[u][2], a[2]);
                        a[3] = fmaf(ep[j1], tmp[u][3], a[3]);
                    }
                }
            }
        }

        // (4) G ⊙ L into the tiles as hi + lo (no warp reads D any more)
        for (int tau = warp; tau < T; tau += kWarps) {
            int I, J;
            tile_ij(tau, I, J);
            const float4* gp = reinterpret_cast<const float4*>(Gf + tau * 256 + lane * 8);
            const float4 ga = gp[0], gb = gp[1];
            const float gv[2][4] = {{ga.x, ga.y, ga.z, ga.w}, {gb.x, gb.y, gb.z, gb.w}};
#pragma unroll
            for (int s = 0; s < 2; ++s) {
                float v[4];
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int i = I * 16 + g + 8 * (k / 2), j = J * 16 + 8 * s + 2 * t + k % 2;
                    v[k] = (j <= i && i < Q) ? gv[s][k] * expf(acs[i] - acs[j]) : 0.f;
                }
                uint32_t hi, lo;
                const int c0 = 8 * s + 2 * t;
                split(v[0], v[1], hi, lo);
                *reinterpret_cast<uint32_t*>(Rh + tile_at(tau, g, c0)) = hi;
                *reinterpret_cast<uint32_t*>(Rl + tile_at(tau, g, c0)) = lo;
                split(v[2], v[3], hi, lo);
                *reinterpret_cast<uint32_t*>(Rh + tile_at(tau, g + 8, c0)) = hi;
                *reinterpret_cast<uint32_t*>(Rl + tile_at(tau, g + 8, c0)) = lo;
            }
        }
        __syncthreads();

        // (5) dx of the warp's items: e' ⊙ (B·gᵀ), w from it, then + (G ⊙ L)ᵀ·dy; stored
        // once in bf16
        if (owner) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int J = it[hf];
                const int pn0 = hf * kXN;
                const int j0 = J * 16 + g, j1 = j0 + 8;
                float acc[kXN][4];
#pragma unroll
                for (int u = 0; u < kXN; ++u)
#pragma unroll
                    for (int k = 0; k < 4; ++k) acc[u][k] = 0.f;
                // B·gᵀ: A = B's rows (k = n), B operand gᵀ (k = n, column p): S row p
#pragma unroll 2
                for (int k0 = 0; k0 < N; k0 += 16) {
                    uint32_t a[4];
                    ldsm_x4(a, Bs + at<N>(J * 16 + lr, k0 + lc * 8, Qp));
#pragma unroll
                    for (int hk = 0; hk < 2; ++hk) {
                        const uint32_t p0 = a[2 * hk], p1 = a[2 * hk + 1];
#pragma unroll
                        for (int u = 0; u < kXN; ++u) {
                            const float2 sv = *reinterpret_cast<const float2*>(
                                S + ((pn0 + u) * 8 + g) * kLdS + k0 + 8 * hk + 2 * t);
                            mma_tf32(acc[u], lo_bits(p0), lo_bits(p1), hi_bits(p0), hi_bits(p1),
                                     tf32(sv.x), tf32(sv.y));
                        }
                    }
                }
                float wa = 0.f, wb = 0.f;
#pragma unroll
                for (int u = 0; u < kXN; ++u) {
                    const int p = (pn0 + u) * 8 + 2 * t;
                    acc[u][0] *= ep[j0];
                    acc[u][1] *= ep[j0];
                    acc[u][2] *= ep[j1];
                    acc[u][3] *= ep[j1];
                    const uint32_t xa = *reinterpret_cast<const uint32_t*>(Xs + at<P>(j0, p, Qp));
                    const uint32_t xb = *reinterpret_cast<const uint32_t*>(Xs + at<P>(j1, p, Qp));
                    wa = fmaf(as_f(lo_bits(xa)), acc[u][0], wa);
                    wa = fmaf(as_f(hi_bits(xa)), acc[u][1], wa);
                    wb = fmaf(as_f(lo_bits(xb)), acc[u][2], wb);
                    wb = fmaf(as_f(hi_bits(xb)), acc[u][3], wb);
                }
                wa += __shfl_xor_sync(0xffffffffu, wa, 1);
                wa += __shfl_xor_sync(0xffffffffu, wa, 2);
                wb += __shfl_xor_sync(0xffffffffu, wb, 1);
                wb += __shfl_xor_sync(0xffffffffu, wb, 2);
                if (t == 0) {
                    wh[hf * kMaxQ + j0] = wa;
                    wh[hf * kMaxQ + j1] = wb;
                }
                for (int I = J; I < RT; ++I) {
                    const int tau = I * (I + 1) / 2 + J;
                    uint32_t ah[4], al[4];
                    ldsm_x4_t(ah, Rh + tile_at(tau, tr, tc_ * 8));
                    ldsm_x4_t(al, Rl + tile_at(tau, tr, tc_ * 8));
#pragma unroll
                    for (int up = 0; up < kXN / 2; ++up) {
                        uint32_t bq[4];
                        ldsm_x4_t(bq, Ys + at<P>(I * 16 + lr, (pn0 + 2 * up + lc) * 8, Qp));
                        mma_bf16(acc[2 * up], ah, bq[0], bq[1]);
                        mma_bf16(acc[2 * up], al, bq[0], bq[1]);
                        mma_bf16(acc[2 * up + 1], ah, bq[2], bq[3]);
                        mma_bf16(acc[2 * up + 1], al, bq[2], bq[3]);
                    }
                }
#pragma unroll
                for (int u = 0; u < kXN; ++u) {
                    const int p = (pn0 + u) * 8 + 2 * t;
                    if (j0 < Q)
                        *reinterpret_cast<uint32_t*>(dx + (row0 + j0) * P + p) =
                            pack_bf16(acc[u][0], acc[u][1]);
                    if (j1 < Q)
                        *reinterpret_cast<uint32_t*>(dx + (row0 + j1) * P + p) =
                            pack_bf16(acc[u][2], acc[u][3]);
                }
            }
        }
        __syncthreads();

        // (6) d(dtA): dAcs_i = rowsum(M)_i - colsum(M)_i + the state's term - w_i, one step a
        // thread; then one warp adds the terms through Λ on the last step and takes the
        // reverse cumsum, four steps a lane
        if (threadIdx.x < Q) {
            const int i = threadIdx.x, I = i / 16, r = i % 16;
            float row = 0.f, col = 0.f;
            for (int J = 0; J <= I; ++J) row += rsum[(I * (I + 1) / 2 + J) * 16 + r];
            for (int I2 = I; I2 < RT; ++I2) col += csum[(I2 * (I2 + 1) / 2 + I) * 16 + r];
            dac[i] = row - col + (drs[i] + drs[kMaxQ + i]) - (wh[i] + wh[kMaxQ + i]);
        }
        __syncthreads();
        if (warp == 0) {
            float dv[4], wsum = 0.f;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int i = lane * 4 + k;
                dv[k] = i < Q ? dac[i] : 0.f;
                wsum += i < Q ? wh[i] + wh[kMaxQ + i] : 0.f;
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) wsum += __shfl_xor_sync(0xffffffffu, wsum, off);
            float gsum = 0.f;
            for (int s = 0; s < kParts; ++s) gsum += gs_part[(bh * kParts + s) * nc + c];
#pragma unroll
            for (int k = 0; k < 4; ++k)
                if (lane * 4 + k == Q - 1) dv[k] += wsum + gsum;
            float suf[4], run = 0.f;  // the lane's suffix sums
#pragma unroll
            for (int k = 3; k >= 0; --k) {
                run += dv[k];
                suf[k] = run;
            }
            float incl = run;  // the sum over this lane and the lanes after it
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const float o = __shfl_down_sync(0xffffffffu, incl, off);
                if (lane + off < 32) incl += o;
            }
            float excl = __shfl_down_sync(0xffffffffu, incl, 1);
            if (lane == 31) excl = 0.f;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int i = lane * 4 + k;
                if (i < Q) ddta[row0 + i] = excl + suf[k];
            }
        }
    }

    // dB and dC of the group, f32, rows below Q
    if (owner) {
        const size_t prow0 =
            (static_cast<size_t>(b) * gridDim.y + gi) * L + static_cast<size_t>(c) * Q;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int i0 = it[hf] * 16 + g, i1 = i0 + 8;
#pragma unroll
            for (int u = 0; u < kNH; ++u) {
                const int n = hf * (N / 2) + u * 8 + 2 * t;
                const float* vc = accC[hf][u];
                const float* vb = accB[hf][u];
                float2* oc = reinterpret_cast<float2*>(dcp + n);
                float2* ob = reinterpret_cast<float2*>(dbp + n);
                if (i0 < Q) {
                    oc[(prow0 + i0) * N / 2] = make_float2(vc[0], vc[1]);
                    ob[(prow0 + i0) * N / 2] = make_float2(vb[0], vb[1]);
                }
                if (i1 < Q) {
                    oc[(prow0 + i1) * N / 2] = make_float2(vc[2], vc[3]);
                    ob[(prow0 + i1) * N / 2] = make_float2(vb[2], vb[3]);
                }
            }
        }
    }
}

template <int N, int P>
cudaError_t launch(const bf16* x, const bf16* dy, const float* dta, const bf16* bm, const bf16* cm,
                   bf16* dx, float* ddta, bf16* db, bf16* dc, float* states, float* dstates,
                   float* gs, float* lam, float* dbp, float* dcp, int B, int H, int L, int Q,
                   int group, int local_bytes, int chunk_bytes, cudaStream_t stream) {
    const int Qp = (Q + 15) / 16 * 16;
    if (group != kGroup || local_bytes != LocalSmem<N, P>::bytes(Qp) ||
        chunk_bytes != ChunkSmem<N, P>::bytes(Qp))
        return cudaErrorInvalidValue;  // the Python plan and this source disagree
    constexpr auto kSmem = cudaFuncAttributeMaxDynamicSharedMemorySize;
    cudaError_t err = cudaFuncSetAttribute(ssd_bwd_local_kernel<N, P>, kSmem, local_bytes);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<N, P>, kSmem, chunk_bytes);
    if (err != cudaSuccess) return err;
    const int nc = L / Q;
    const int groups = (H + kGroup - 1) / kGroup;
    ssd_bwd_local_kernel<N, P><<<dim3(nc, groups, B), kThreads, local_bytes, stream>>>(
        x, dy, dta, bm, cm, states, dstates, lam, H, L, Q);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    constexpr int kCarryThreads = Carry<P * N>::kThreads;
    constexpr int kCarrySlices = Carry<P * N>::kSlices;
    ssd_bwd_carry_kernel<P * N><<<dim3(kCarrySlices, H, B), kCarryThreads, 0, stream>>>(
        states, dstates, lam, gs, H, nc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ssd_bwd_chunk_kernel<N, P><<<dim3(nc, groups, B), kThreads, chunk_bytes, stream>>>(
        x, dy, dta, bm, cm, states, dstates, gs, dx, ddta, dbp, dcp, H, L, Q);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long per_batch = static_cast<long long>(L) * N;
    const long long total = per_batch * B;
    const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
    bwd_reduce_kernel<bf16><<<dim3(blocks, 2), kThreads, 0, stream>>>(dbp, dcp, db, dc, groups,
                                                                     per_batch, total);
    return cudaGetLastError();
}

template <int P>
cudaError_t launch_n(const bf16* x, const bf16* dy, const float* dta, const bf16* bm,
                     const bf16* cm, bf16* dx, float* ddta, bf16* db, bf16* dc, float* states,
                     float* dstates, float* gs, float* lam, float* dbp, float* dcp, int B, int H,
                     int L, int N, int Q, int group, int local_bytes, int chunk_bytes,
                     cudaStream_t st) {
#define SSD_BWD_TC_N(NN)                                                                      \
    case NN:                                                                                  \
        return launch<NN, P>(x, dy, dta, bm, cm, dx, ddta, db, dc, states, dstates, gs, lam, \
                             dbp, dcp, B, H, L, Q, group, local_bytes, chunk_bytes, st);
    switch (N) {
        SSD_BWD_TC_N(16)
        SSD_BWD_TC_N(32)
        SSD_BWD_TC_N(64)
        SSD_BWD_TC_N(128)
        default: return cudaErrorInvalidValue;
    }
#undef SSD_BWD_TC_N
}

}  // namespace tc
#endif  // __CUDACC__ || CUDA_EMU_MMA

}  // namespace

// x, dy, dx (B,H,L,P) and bm, cm, db, dc (B,L,N) in one dtype, dta and ddta (B,H,L) f32,
// all contiguous, with the f32 scratch of the Python plan (kernels/ssd_scan.py:
// bwd_geometry). dtype 0 = float32 (the SIMT kernels): states and dstates (B,H,L/Q,P,N),
// gs (B,H,L/Q), dbp and dcp (B,H,L,N); slab must be 32, smem_a and smem_b the scan and
// chunk kernels' shared memory; lam and group are not read. dtype 2 = bfloat16 (the
// tensor-core kernels; x, dy, bm and cm 16-byte aligned): states and dstates
// (B,H,L/Q,P,N), gs (B,H,parts,L/Q), lam (B,H,L/Q), dbp and dcp (B,groups,L,N); group
// must be 8, smem_a and smem_b the local and chunk kernels' shared memory; slab is not
// read. P in {32, 64}, N in {16, 32, 64, 128}, 1 <= Q <= 128 and L a multiple of Q.
// Returns the cudaError_t of the launches (0 = cudaSuccess); cudaErrorInvalidValue for
// anything else, and for bfloat16 where the tensor-core kernels are not built.
extern "C" int ssd_scan_bwd_launch(const void* x, const void* dy, const void* dta,
                                   const void* bm, const void* cm, void* dx, void* ddta,
                                   void* db, void* dc, void* states, void* dstates, void* gs,
                                   void* lam, void* dbp, void* dcp, int B, int H, int L, int P,
                                   int N, int Q, int slab, int group, int smem_a, int smem_b,
                                   int dtype, void* stream) {
    if (B <= 0 || H <= 0 || L <= 0) return cudaSuccess;
    if (Q < 1 || Q > kMaxQ || L % Q != 0) return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* a = static_cast<const float*>(dta);
    float* da = static_cast<float*>(ddta);
    float* s = static_cast<float*>(states);
    float* g = static_cast<float*>(dstates);
    float* w = static_cast<float*>(gs);
    float* pb = static_cast<float*>(dbp);
    float* pc = static_cast<float*>(dcp);
    switch (dtype) {
        case 0: {
            if (slab != kSlab) return cudaErrorInvalidValue;
            using F = const float*;
            return static_cast<int>(launch_p(
                static_cast<F>(x), static_cast<F>(dy), a, static_cast<F>(bm), static_cast<F>(cm),
                static_cast<float*>(dx), da, static_cast<float*>(db), static_cast<float*>(dc), s,
                g, w, pb, pc, B, H, L, P, N, Q, smem_a, smem_b, st));
        }
#if defined(__CUDACC__) || defined(CUDA_EMU_MMA)
        case 2: {
            using tc::bf16;
            using Bp = const bf16*;
            float* lm = static_cast<float*>(lam);
#define SSD_BWD_TC_P(PP)                                                                      \
    case PP:                                                                                  \
        return static_cast<int>(tc::launch_n<PP>(                                             \
            static_cast<Bp>(x), static_cast<Bp>(dy), a, static_cast<Bp>(bm),                  \
            static_cast<Bp>(cm), static_cast<bf16*>(dx), da, static_cast<bf16*>(db),          \
            static_cast<bf16*>(dc), s, g, w, lm, pb, pc, B, H, L, N, Q, group, smem_a, smem_b, \
            st));
            switch (P) {
                SSD_BWD_TC_P(32)
                SSD_BWD_TC_P(64)
                default: return static_cast<int>(cudaErrorInvalidValue);
            }
#undef SSD_BWD_TC_P
        }
#endif
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
