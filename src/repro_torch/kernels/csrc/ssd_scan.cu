// Mamba2 SSD chunked scan (the state-space dual form), forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:ssd_scan_fwd (Pallas; grid
// (B, H, chunks) with the chunk axis sequential and the f32 (P, N) state carried in
// VMEM scratch). Per chunk of Q steps, with Acs the inclusive cumsum of dtA:
//
//     y     = ((C Bᵀ) ⊙ L) x + (C stateᵀ) ⊙ exp(Acs),   L[i][j] = exp(Acs_i - Acs_j), j <= i
//     state = state · exp(Acs_Q) + (x ⊙ exp(Acs_Q - Acs))ᵀ B
//
// x (B,H,L,P) and y in f32 or bf16, dtA (B,H,L) f32, B and C (B,L,N) in x's type,
// shared by all heads (n_groups 1). The mask is applied before the exp (-1e9 above the
// diagonal, as the TPU kernel does), the state starts at zero and is carried in f32,
// y is rounded once to x's type, and the final state is written in f32 on request.
// Q is a runtime value from 1 to 128 (L % Q == 0 is the wrapper's check).
//
// What bounds it on this card: bytes, at both dtypes. Each (b, h) reads its x, dtA and
// the shared B and C once and writes y; the operations this input needs (C·Bᵀ once per
// (b, chunk), three products per (b, h, chunk)) take less time at the tensor cores'
// rate: at the serving shape 8.2 GFLOP, 8.3 µs at the bf16 peak, against 19.6 µs for
// the bytes at 3.35 TB/s. ssd_scan_launch dispatches by dtype.
//
// bfloat16: the tensor-core pair (namespace tc), two launches:
//   * scores_kernel computes G = C·Bᵀ once per (b, chunk), lower-triangle tiles only,
//     with mma.sync m16n8k16 (bf16 in, f32 out), into an f32 scratch (B, L/Q, Qp, Qp)
//     that the wrapper allocates (Qp = Q rounded up to 16); one CTA per 16-row tile.
//     At Mamba2's n_groups 1 it serves all heads, where the SIMT kernel recomputes it
//     per head. bf16 products summed in f32 add no rounding; G (2 MB at both timed
//     shapes) stays in L2;
//   * scan_kernel: one CTA of 16 warps per (b, h, tile of TP state rows) walks the
//     chunks in order (the wrapper's state_split picks TP). A warp computes y for two
//     16-row tiles r and 7 - r (which evens out the rows under the diagonal; one tile
//     at TP 16) by a share of the columns: C·stateᵀ, then (G ⊙ L)·x with x by
//     ldmatrix.trans. G ⊙ L is built once a chunk by all 512 threads, G read from L2
//     into registers, multiplied by L and written to shared memory as two bf16 terms,
//     hi = bf16(v) and lo = bf16(v - hi), in the lower-triangle 16x16 tiles, which
//     the warps read by ldmatrix (built in each warp's registers straight from L2,
//     the last row tile's warp waited on eight dependent L2 round trips a chunk). One
//     bf16 term, as flash_attention rounds P, added some 40% to y's error against the
//     plain version and took Mamba2-780M's first-step logits past 5% of the plain
//     scan's (measured); two terms cost one more mma a product. Each warp also
//     owns a slice of the state: the f32 state lives in mma accumulators and is
//     decayed and updated by (x ⊙ exp(Acs_Q - Acs))ᵀ·B with m16n8k8 TF32 (the decayed
//     x rounded to TF32, B exact); a bf16 copy in shared memory, refreshed once a
//     chunk, feeds the next C·stateᵀ on the bf16 tensor cores;
//   * the next chunk's x tile, B and C arrive by TMA (2-D tensor maps, one thread
//     issuing, completion on the stage's mbarrier) in the other half of a 2-stage
//     ring while this chunk computes, dtA by warp 0's cp.async; warp 0 takes its
//     cumsum at the end of the chunk and every thread one of its exps at the start of
//     the next. The slabs land XOR-swizzled by TMA (128/64/32-byte swizzle, boxes of
//     at most 64 columns), which keeps ldmatrix free of bank conflicts. Rows past Q
//     are zeros, so Q need not be a multiple of 16 (the last row tile is masked), and
//     N 8 pads half a k16 step with zeros. At Q 128, N 128, TP 64 the CTA takes
//     223,280 bytes of shared memory: one CTA an SM;
//   * two barriers a chunk: (1) the stage has landed; C·stateᵀ and G ⊙ L; (2) the
//     state update, the state copy, (G ⊙ L)·x and y;
//   * mma.sync rather than wgmma: the operations are below the bytes bound even at
//     half the tensor rate, and the tiles (16 rows of a chunk, 8-column tiles of y and
//     of the state, masks on the diagonal) fit mma.sync's small fragments;
//   * the numeric budget: G ⊙ L in two bf16 terms adds ≲ 2^-17 relative a term, the
//     decayed x in TF32 ≲ 2^-11 a term of the state (round to nearest even), the bf16
//     state copy ≲ 2^-9 a term of C·stateᵀ, which decays within a chunk at the
//     model's rates and reaches y only; the sums and the carried state stay f32. Against the plain f32 version:
//     y within 2e-2 of its scale, the state within 1e-3 of its scale.
//
// float32: ssd_scan_kernel on the f32 SIMT pipes (on the tensor cores f32 would run
// as TF32). It runs every product as scalar FMAs and recomputes C·Bᵀ for every head,
// about twice the needed operations at a fifteenth of the tensor cores' rate, so it
// is bound by those in practice. Its design:
//   * blocks run in no order, so the TPU's sequential chunk axis becomes a loop inside
//     the block: one block of 256 threads owns (b, h, a tile of TP state rows) and walks
//     the chunks in order, the f32 (TP, N) state kept in shared memory;
//   * the P state rows evolve independently given dtA, B and C, so the wrapper may
//     split P into P/TP tiles (more blocks for a small batch; each split recomputes
//     C·Bᵀ); at B·H >= the SM count it does not split;
//   * per chunk, B, C and the x tile are staged in shared memory as f32 (rows of B and
//     C padded to N+1 floats, so reads of 32 different rows fall in distinct banks), and
//     one warp takes the cumsum of dtA as a warp scan;
//   * the (Q, Q) masked score matrix is never held whole: 32 rows at a time go to
//     shared memory (only the column tiles at or below the diagonal are computed), and
//     those 32 rows of y are finished from them before the next slab;
//   * each product is register-tiled (a thread owns a small tile of outputs) so a
//     shared-memory load feeds several FMAs;
//   * Q is a runtime value from 1 to 128 (L % Q == 0 is the wrapper's check); rows past
//     Q are clamped on load and never stored.
// At Q 128, N 128, TP 64 the block takes 214,784 bytes of shared memory: one block an SM.

#include <cuda.h>  // CUtensorMap and its enums; the driver's encoder is reached through
                   // cudaGetDriverEntryPoint, so the library needs no -lcuda
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 128;
constexpr int kSlab = 32;  // rows of the masked score matrix held at once
constexpr float kMaskNeg = -1e9f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <int N, int TP>
struct Smem {
    static constexpr int kLdN = N + 1;
    // acs, B, C, the x tile, the state and one slab of scores, in floats, for a chunk of Q
    static __host__ __device__ int floats(int Q) {
        const int qp = (Q + kSlab - 1) / kSlab * kSlab;
        return kMaxQ + 2 * Q * kLdN + Q * TP + TP * kLdN + kSlab * qp;
    }
};

// rows [0, rows) of COLS elements (source row stride src_ld) into f32 shared memory
template <typename T, int COLS>
__device__ __forceinline__ void stage(float* dst, int ld, const T* __restrict__ src,
                                      size_t src_ld, int rows) {
    for (int i = threadIdx.x; i < rows * COLS; i += kThreads) {
        const int r = i / COLS;
        const int c = i % COLS;
        dst[r * ld + c] = to_f32(src[r * src_ld + c]);
    }
}

// acs[i] = a[0] + ... + a[i] for i < Q (Q <= 128), by one warp: each lane sums four
// consecutive steps, then the lanes' totals are scanned with shuffles
__device__ __forceinline__ void chunk_cumsum(float* acs, const float* __restrict__ a, int Q) {
    const int lane = threadIdx.x;
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
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int i = lane * 4 + k;
        if (i < Q) acs[i] = excl + v[k];
    }
}

// rows s*32 .. s*32+31 of (C Bᵀ) ⊙ L into Gs (row stride ldg), column tiles 0..NG-1
// (the tiles at or below the diagonal). Thread: 4 rows x NG columns, lane + 32*g.
template <int N, int NG>
__device__ __forceinline__ void masked_scores(float* Gs, int ldg, const float* Bs,
                                              const float* Cs, const float* acs, int s, int Q) {
    constexpr int kLdN = N + 1;
    const int r0 = (threadIdx.x / 32) * 4;
    const int lane = threadIdx.x % 32;
    int ci[4], bj[NG];
#pragma unroll
    for (int a = 0; a < 4; ++a) ci[a] = min(s * kSlab + r0 + a, Q - 1) * kLdN;
#pragma unroll
    for (int g = 0; g < NG; ++g) bj[g] = min(lane + 32 * g, Q - 1) * kLdN;
    float acc[4][NG];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int g = 0; g < NG; ++g) acc[a][g] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
        float cv[4], bv[NG];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = Cs[ci[a] + n];
#pragma unroll
        for (int g = 0; g < NG; ++g) bv[g] = Bs[bj[g] + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int g = 0; g < NG; ++g) acc[a][g] = fmaf(cv[a], bv[g], acc[a][g]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        const int i = s * kSlab + r0 + a;
        if (i >= Q) continue;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
            const int j = lane + 32 * g;
            if (j >= Q) continue;
            const float decay = expf(j <= i ? acs[i] - acs[j] : kMaskNeg);
            Gs[(r0 + a) * ldg + j] = acc[a][g] * decay;
        }
    }
}

// rows s*32 .. s*32+31 of y: the slab of scores times x, plus C stateᵀ scaled by
// exp(Acs). Thread: RT rows x PT columns of the TP-wide tile.
template <typename T, int N, int TP>
__device__ __forceinline__ void slab_output(T* __restrict__ yc, int P, const float* Gs, int ldg,
                                            const float* Xs, const float* Cs, const float* St,
                                            const float* acs, int s, int Q) {
    constexpr int kLdN = N + 1;
    constexpr int PT = TP >= 32 ? 2 : 1;  // columns per thread
    constexpr int PL = TP / PT;           // threads along the columns
    constexpr int RG = kThreads / PL;     // row groups
    constexpr int RT = kSlab / RG;        // rows per thread
    const int pl = threadIdx.x % PL;
    const int rg = threadIdx.x / PL;
    const int jmax = min((s + 1) * kSlab, Q);

    float acc[RT][PT], off[RT][PT];
#pragma unroll
    for (int k = 0; k < RT; ++k)
#pragma unroll
        for (int a = 0; a < PT; ++a) acc[k][a] = off[k][a] = 0.f;
#pragma unroll 4
    for (int j = 0; j < jmax; ++j) {
        float gv[RT], xv[PT];
#pragma unroll
        for (int k = 0; k < RT; ++k) gv[k] = Gs[(rg + RG * k) * ldg + j];
#pragma unroll
        for (int a = 0; a < PT; ++a) xv[a] = Xs[j * TP + pl + PL * a];
#pragma unroll
        for (int k = 0; k < RT; ++k)
#pragma unroll
            for (int a = 0; a < PT; ++a) acc[k][a] = fmaf(gv[k], xv[a], acc[k][a]);
    }
    int ci[RT];
#pragma unroll
    for (int k = 0; k < RT; ++k) ci[k] = min(s * kSlab + rg + RG * k, Q - 1) * kLdN;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
        float cv[RT], sv[PT];
#pragma unroll
        for (int k = 0; k < RT; ++k) cv[k] = Cs[ci[k] + n];
#pragma unroll
        for (int a = 0; a < PT; ++a) sv[a] = St[(pl + PL * a) * kLdN + n];
#pragma unroll
        for (int k = 0; k < RT; ++k)
#pragma unroll
            for (int a = 0; a < PT; ++a) off[k][a] = fmaf(cv[k], sv[a], off[k][a]);
    }
#pragma unroll
    for (int k = 0; k < RT; ++k) {
        const int i = s * kSlab + rg + RG * k;
        if (i >= Q) continue;
        const float in_decay = expf(acs[i]);
#pragma unroll
        for (int a = 0; a < PT; ++a)
            store1(yc + static_cast<size_t>(i) * P + pl + PL * a, acc[k][a] + off[k][a] * in_decay);
    }
}

// state = state · exp(Acs_last) + (x ⊙ exp(Acs_last - Acs))ᵀ B. The x tile is scaled in
// place first. Thread: PT state rows x NT state columns.
template <int N, int TP>
__device__ __forceinline__ void update_state(float* St, float* Xs, const float* Bs,
                                             const float* acs, int Q) {
    constexpr int kLdN = N + 1;
    constexpr int E = TP * N / kThreads > 0 ? TP * N / kThreads : 1;  // outputs per thread
    constexpr int NT = E < 8 ? E : 8;
    constexpr int PT = E / NT;
    constexpr int NL = N / NT;      // threads along n
    constexpr int PLS = TP / PT;    // threads along p
    const float last = acs[Q - 1];
    for (int i = threadIdx.x; i < Q * TP; i += kThreads) Xs[i] *= expf(last - acs[i / TP]);
    __syncthreads();
    if (threadIdx.x >= NL * PLS) return;
    const int nl = threadIdx.x % NL;
    const int pl = threadIdx.x / NL;
    float acc[PT][NT];
#pragma unroll
    for (int a = 0; a < PT; ++a)
#pragma unroll
        for (int c = 0; c < NT; ++c) acc[a][c] = 0.f;
#pragma unroll 4
    for (int j = 0; j < Q; ++j) {
        float xv[PT], bv[NT];
#pragma unroll
        for (int a = 0; a < PT; ++a) xv[a] = Xs[j * TP + pl + PLS * a];
#pragma unroll
        for (int c = 0; c < NT; ++c) bv[c] = Bs[j * kLdN + nl + NL * c];
#pragma unroll
        for (int a = 0; a < PT; ++a)
#pragma unroll
            for (int c = 0; c < NT; ++c) acc[a][c] = fmaf(xv[a], bv[c], acc[a][c]);
    }
    const float chunk_decay = expf(last);
#pragma unroll
    for (int a = 0; a < PT; ++a)
#pragma unroll
        for (int c = 0; c < NT; ++c) {
            float* st = St + (pl + PLS * a) * kLdN + nl + NL * c;
            *st = *st * chunk_decay + acc[a][c];
        }
}

template <typename T, int N, int TP>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dta,
                const T* __restrict__ bm, const T* __restrict__ cm, T* __restrict__ y,
                float* __restrict__ final_state, int H, int L, int P, int Q) {
    using S = Smem<N, TP>;
    constexpr int kLdN = S::kLdN;
    const int ldg = (Q + kSlab - 1) / kSlab * kSlab;
    extern __shared__ float4 smem4[];
    float* acs = reinterpret_cast<float*>(smem4);
    float* Bs = acs + kMaxQ;
    float* Cs = Bs + Q * kLdN;
    float* Xs = Cs + Q * kLdN;
    float* St = Xs + Q * TP;
    float* Gs = St + TP * kLdN;

    const int p0 = blockIdx.x * TP;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const size_t bh = static_cast<size_t>(b) * H + h;
    const T* xb = x + bh * L * P + p0;
    const float* ab = dta + bh * L;
    const T* bb = bm + static_cast<size_t>(b) * L * N;
    const T* cb = cm + static_cast<size_t>(b) * L * N;
    T* yb = y + bh * L * P + p0;

    for (int i = threadIdx.x; i < TP * kLdN; i += kThreads) St[i] = 0.f;

    const int n_chunks = L / Q;
    for (int c = 0; c < n_chunks; ++c) {
        const size_t t0 = static_cast<size_t>(c) * Q;
        __syncthreads();  // the previous chunk is done with B, C, x, acs and the state
        stage<T, N>(Bs, kLdN, bb + t0 * N, N, Q);
        stage<T, N>(Cs, kLdN, cb + t0 * N, N, Q);
        stage<T, TP>(Xs, TP, xb + t0 * P, P, Q);
        if (threadIdx.x < 32) chunk_cumsum(acs, ab + t0, Q);
        __syncthreads();

        for (int s = 0; s * kSlab < Q; ++s) {
            switch (s) {
                case 0: masked_scores<N, 1>(Gs, ldg, Bs, Cs, acs, s, Q); break;
                case 1: masked_scores<N, 2>(Gs, ldg, Bs, Cs, acs, s, Q); break;
                case 2: masked_scores<N, 3>(Gs, ldg, Bs, Cs, acs, s, Q); break;
                default: masked_scores<N, 4>(Gs, ldg, Bs, Cs, acs, s, Q); break;
            }
            __syncthreads();
            slab_output<T, N, TP>(yb + t0 * P, P, Gs, ldg, Xs, Cs, St, acs, s, Q);
            __syncthreads();  // the slab's scores and the state are read
        }
        update_state<N, TP>(St, Xs, Bs, acs, Q);
    }
    if (final_state == nullptr) return;
    __syncthreads();
    float* fb = final_state + (bh * P + p0) * N;
    for (int i = threadIdx.x; i < TP * N; i += kThreads) fb[i] = St[(i / N) * kLdN + i % N];
}

template <typename T, int N, int TP>
cudaError_t launch(const void* x, const float* dta, const void* bm, const void* cm, void* y,
                   float* final_state, int B, int H, int L, int P, int Q, cudaStream_t stream) {
    const size_t bytes = sizeof(float) * static_cast<size_t>(Smem<N, TP>::floats(Q));
    // above 48 KiB of dynamic shared memory a kernel must opt in; set on every call
    cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T, N, TP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    const dim3 grid(P / TP, H, B);
    ssd_scan_kernel<T, N, TP><<<grid, kThreads, bytes, stream>>>(
        static_cast<const T*>(x), dta, static_cast<const T*>(bm), static_cast<const T*>(cm),
        static_cast<T*>(y), final_state, H, L, P, Q);
    return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch_tp(const void* x, const float* dta, const void* bm, const void* cm, void* y,
                      float* final_state, int B, int H, int L, int P, int Q, int tp,
                      cudaStream_t stream) {
    switch (tp) {
        case 16: return launch<T, N, 16>(x, dta, bm, cm, y, final_state, B, H, L, P, Q, stream);
        case 32: return launch<T, N, 32>(x, dta, bm, cm, y, final_state, B, H, L, P, Q, stream);
        case 64: return launch<T, N, 64>(x, dta, bm, cm, y, final_state, B, H, L, P, Q, stream);
        default: return cudaErrorInvalidValue;
    }
}

template <typename T>
cudaError_t launch_n(const void* x, const float* dta, const void* bm, const void* cm, void* y,
                     float* final_state, int B, int H, int L, int P, int N, int Q, int tp,
                     cudaStream_t stream) {
    switch (N) {
        case 8: return launch_tp<T, 8>(x, dta, bm, cm, y, final_state, B, H, L, P, Q, tp, stream);
        case 16: return launch_tp<T, 16>(x, dta, bm, cm, y, final_state, B, H, L, P, Q, tp, stream);
        case 32: return launch_tp<T, 32>(x, dta, bm, cm, y, final_state, B, H, L, P, Q, tp, stream);
        case 64: return launch_tp<T, 64>(x, dta, bm, cm, y, final_state, B, H, L, P, Q, tp, stream);
        case 128: return launch_tp<T, 128>(x, dta, bm, cm, y, final_state, B, H, L, P, Q, tp, stream);
        default: return cudaErrorInvalidValue;
    }
}


// ------------------------------------------------------------------ bfloat16: tensor cores
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;

// f32 -> TF32 (10 mantissa bits), round to nearest even, as bits the mma reads
__device__ __forceinline__ uint32_t tf32(float v) {
    uint32_t r;
    asm("cvt.rn.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
    return r;
}
// the f32 bits of the low and high bf16 of a packed pair: exact, and exact in TF32
__device__ __forceinline__ uint32_t lo_bits(uint32_t pair) { return pair << 16; }
__device__ __forceinline__ uint32_t hi_bits(uint32_t pair) { return pair & 0xFFFF0000u; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// d (16x8 f32) += a (16x16 bf16, row) · b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (16x8 f32) += a (16x8 tf32, row) · b (8x8 tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int PENDING>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(PENDING) : "memory");
}

// 16-byte chunk c of row `row` of a shared-memory slab whose rows hold CR chunks, XOR-
// swizzled so that the same chunk of 8 consecutive rows (or of rows 2 apart) falls in
// distinct bank groups: ldmatrix and the fragment reads below are free of conflicts
template <int CR>
__device__ __forceinline__ int swz(int row, int c) {
    if constexpr (CR >= 8) return c ^ (row & 7);
    else return c ^ ((row / (8 / CR)) & (CR - 1));
}
// element (row, col) of a (Qp, COLS) bf16 slab as TMA writes it: boxes of at most 64
// columns (128 bytes, one swizzle span) by all Qp rows, each row's 16-byte chunks
// XOR-swizzled as TMA's 128/64/32-byte swizzle does (= swz)
template <int COLS>
__device__ __forceinline__ int at(int row, int col, int Qp) {
    constexpr int kBW = COLS < 64 ? COLS : 64;
    return (col / kBW) * Qp * kBW + row * kBW + swz<kBW / 8>(row, (col % kBW) / 8) * 8 + col % 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x1_t(uint32_t& r, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];"
                 : "=r"(r) : "r"(smem_u32(p)));
}

// rows [0, Q) of a (rows, COLS) bf16 slab from global memory into a shared slab laid
// out as `at` says, by cp.async, 16 bytes a copy, every thread of the block taking a
// share; rows [Q, Qp) become zeros
template <int COLS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, int Q, int Qp) {
    for (int i = threadIdx.x; i < Q * (COLS / 8); i += blockDim.x) {
        const int r = i / (COLS / 8), c8 = i % (COLS / 8);
        cp16(dst + at<COLS>(r, c8 * 8, Qp), src + static_cast<size_t>(r) * COLS + c8 * 8);
    }
    for (int i = threadIdx.x; i < (Qp - Q) * COLS; i += blockDim.x)
        dst[at<COLS>(Q + i / COLS, i % COLS, Qp)] = __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_expect_tx(uint32_t bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}
// returns once the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
    asm volatile(
        "{\n.reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@done bra DONE;\n"
        "bra WAIT;\n"
        "DONE:\n}\n" :: "r"(bar), "r"(parity) : "memory");
}
// one box of a 2-D tensor map at element coordinates (c0, c1) into shared memory;
// completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
        : "memory");
}

// Kernel 1: G = C·Bᵀ of one (chunk, b), the lower-triangle tiles, into f32 scratch
// (B, L/Q, Qp, Qp), one CTA of 4 warps per 16-row tile: it stages those rows of C and
// rows [0, 16(r+1)) of B in shared memory (cp.async), then warp w computes the 8-column
// tiles w, w + 4, ... at or left of the diagonal. Rows and columns past Q come out zero.
constexpr int kScoreWarps = 4;
template <int N>
__global__ void __launch_bounds__(kScoreWarps * 32)
scores_kernel(const bf16* __restrict__ bm, const bf16* __restrict__ cm, float* __restrict__ G,
              int L, int Q) {
    constexpr int kSteps = (N + 15) / 16;
    const int Qp = (Q + 15) / 16 * 16;
    const int rt = blockIdx.z;
    const int rows_b = min(Q, 16 * (rt + 1));  // rows of B this tile needs
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* Cs = reinterpret_cast<bf16*>(smem);  // 16 rows
    bf16* Bs = Cs + 16 * N;                      // 16(rt + 1) rows
    const size_t row0 = static_cast<size_t>(blockIdx.y) * L + static_cast<size_t>(blockIdx.x) * Q;
    stage_rows<N>(Cs, cm + (row0 + 16 * rt) * N, max(0, min(16, Q - 16 * rt)), 16);
    stage_rows<N>(Bs, bm + row0 * N, rows_b, 16 * (rt + 1));
    cp_commit();
    cp_wait<0>();
    __syncthreads();

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    float* Gc = G + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * Qp * Qp +
                static_cast<size_t>(rt) * 16 * Qp;
    // the pair of bf16 at (row, col) of a staged slab of `rows` rows, col even; 0 past N
    auto pair = [&](const bf16* slab, int rows, int row, int col) {
        return col < N ? *reinterpret_cast<const uint32_t*>(slab + at<N>(row, col, rows)) : 0u;
    };
    uint32_t a[kSteps][4];
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
        const int n0 = ks * 16 + 2 * t;
        a[ks][0] = pair(Cs, 16, g, n0);
        a[ks][1] = pair(Cs, 16, g + 8, n0);
        a[ks][2] = pair(Cs, 16, g, n0 + 8);
        a[ks][3] = pair(Cs, 16, g + 8, n0 + 8);
    }
    for (int jt = warp; jt < 2 * (rt + 1); jt += kScoreWarps) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
            const int n0 = ks * 16 + 2 * t;
            mma_bf16(d, a[ks], pair(Bs, 16 * (rt + 1), jt * 8 + g, n0),
                     pair(Bs, 16 * (rt + 1), jt * 8 + g, n0 + 8));
        }
        const int col = jt * 8 + 2 * t;
        *reinterpret_cast<float2*>(Gc + g * Qp + col) = make_float2(d[0], d[1]);
        *reinterpret_cast<float2*>(Gc + (g + 8) * Qp + col) = make_float2(d[2], d[3]);
    }
}

// Shared memory of kernel 2, for a chunk padded to Qp rows, from a 1024-byte aligned
// base (TMA's 128-byte swizzle needs it): 2 stages of [x tile (Qp, TP) | B (Qp, N) |
// C (Qp, N) | dtA (128) f32], the bf16 slabs as `at` lays them out | the state copy
// (TP, N) bf16, laid out the same way | G ⊙ L (the lower-triangle 16x16 tiles) bf16 | 2 sets (this
// chunk's and the next's) of acs, exp(acs), exp(last - acs) (128 f32 each) and
// exp(last) | the stages' mbarriers
template <int N, int TP>
struct Smem {
    static __host__ __device__ int up(int b) { return (b + 1023) / 1024 * 1024; }
    static __host__ __device__ int x_bytes(int Qp) { return up(Qp * TP * 2); }
    static __host__ __device__ int bc_bytes(int Qp) { return up(Qp * N * 2); }
    static __host__ __device__ int stage_bytes(int Qp) { return x_bytes(Qp) + 2 * bc_bytes(Qp) + 1024; }
    static __host__ __device__ int state_off(int Qp) { return 2 * stage_bytes(Qp); }
    static __host__ __device__ int gl_off(int Qp) { return state_off(Qp) + up(TP * N * 2); }
    static __host__ __device__ int vec_off(int Qp) {
        const int rt = Qp / 16;
        return gl_off(Qp) + rt * (rt + 1) / 2 * 1024;  // two bf16 terms a tile
    }
    static constexpr int kVecFloats = 3 * 128 + 4;
    static __host__ __device__ int bar_off(int Qp) { return vec_off(Qp) + 2 * kVecFloats * 4; }
    // + room to align the base to 1024
    static __host__ __device__ int bytes(int Qp) { return bar_off(Qp) + 16 + 1024; }
};

constexpr int kMaxPairs = 9;  // pairs of G ⊙ L a thread builds a chunk: 36 tiles · 128 / 512
// lower-triangle tile t = r(r+1)/2 + k of a chunk's 8x8 grid of 16x16 tiles: r | k << 8
__constant__ int kTileRK[36] = {0, 1, 257, 2, 258, 514, 3, 259, 515, 771, 4, 260, 516, 772, 1028, 5, 261, 517, 773, 1029, 1285, 6, 262, 518, 774, 1030, 1286, 1542, 7, 263, 519, 775, 1031, 1287, 1543, 1799};

// Kernel 2: the scan of one (b, h, tile of TP state rows), walking the chunks in order,
// 16 warps. Per chunk, between two barriers: (1) the next chunk's x, B and C go out by
// TMA and its dtA by warp 0; each thread takes one of exp(acs), exp(last - acs); each
// thread loads its share of G from L2 into registers while every warp computes
// C·stateᵀ for its rows of y, then G ⊙ L is built once by all threads into shared
// memory as bf16; (2) each warp's slice of the state update, the state copy refreshed,
// (G ⊙ L)·x for the warp's rows, y stored, and warp 0 takes the next chunk's cumsum.
// The f32 state lives in the warps' mma accumulators; its bf16 copy in shared memory
// feeds C·stateᵀ.
template <int N, int TP>
__global__ void __launch_bounds__(kThreads, 1)
scan_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_b,
            const __grid_constant__ CUtensorMap tm_c, const float* __restrict__ dta,
            const float* __restrict__ G, bf16* __restrict__ y, float* __restrict__ final_state,
            int H, int L, int P, int Q) {
    using S = Smem<N, TP>;
    constexpr int kPT = TP / 8;                  // 8-column tiles of y
    // y: a warp computes kRT row tiles of 16 (at TP >= 32 a pair r, 7 - r, which evens
    // out the rows under the diagonal) by kPTW 8-column tiles
    constexpr int kRT = TP >= 32 ? 2 : 1;
    constexpr int kPTW = kPT / (kWarps / (8 / kRT));
    constexpr int kNT = N / 8;                   // 8-column tiles of the state
    constexpr int kWP = kWarps / (TP / 16);      // warps per 16 state rows
    constexpr int kTPW = (kNT + kWP - 1) / kWP;  // state tiles per warp
    const int Qp = (Q + 15) / 16 * 16;
    const int RT = Qp / 16;                      // 16-row tiles of the chunk

    extern __shared__ __align__(128) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
    auto Xs = [&](int s) { return reinterpret_cast<bf16*>(smem + s * S::stage_bytes(Qp)); };
    auto Bs = [&](int s) { return reinterpret_cast<bf16*>(smem + s * S::stage_bytes(Qp) + S::x_bytes(Qp)); };
    auto Cs = [&](int s) {
        return reinterpret_cast<bf16*>(smem + s * S::stage_bytes(Qp) + S::x_bytes(Qp) + S::bc_bytes(Qp));
    };
    auto As = [&](int s) {
        return reinterpret_cast<float*>(smem + s * S::stage_bytes(Qp) + S::x_bytes(Qp) + 2 * S::bc_bytes(Qp));
    };
    bf16* St = reinterpret_cast<bf16*>(smem + S::state_off(Qp));  // the state copy
    // G ⊙ L as two bf16 terms, hi + lo; tile (r, k <= r) at r(r+1)/2 + k
    bf16* GL = reinterpret_cast<bf16*>(smem + S::gl_off(Qp));
    bf16* GL_lo = GL + RT * (RT + 1) / 2 * 256;
    // vector set v: acs, exp(acs_i) and exp(last - acs_j) (0 past Q), exp(last)
    auto vecs = [&](int v) { return reinterpret_cast<float*>(smem + S::vec_off(Qp)) + v * S::kVecFloats; };

    const int p0 = blockIdx.x * TP;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const size_t bh = static_cast<size_t>(b) * H + h;
    const float* ab = dta + bh * L;
    bf16* yb = y + bh * L * P + p0;
    const uint32_t full0 = smem_u32(smem + S::bar_off(Qp));  // stage s's barrier: full0 + 8s
    const int n_chunks = L / Q;

    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4, t = lane % 4;

    // x, B and C of chunk c into stage s by TMA, one thread issuing, completion on the
    // stage's mbarrier; dtA of chunk c by warp 0 alone (cp.async, 4 bytes a copy: Q
    // steps need not fill 16 bytes), which it alone waits for
    constexpr int kBW = N < 64 ? N : 64;  // columns of a box of B or C
    auto issue = [&](int s, int c) {
        const int row = c * Q;
        if (tid == 0) {
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            bar_expect_tx(full0 + 8 * s, Q * TP * 2 + 2 * Q * N * 2);
            tma_load(Xs(s), &tm_x, full0 + 8 * s, p0, static_cast<int>(bh) * L + row);
#pragma unroll
            for (int box = 0; box < N / kBW; ++box) {
                tma_load(Bs(s) + box * Qp * kBW, &tm_b, full0 + 8 * s, box * kBW, b * L + row);
                tma_load(Cs(s) + box * Qp * kBW, &tm_c, full0 + 8 * s, box * kBW, b * L + row);
            }
        }
        if (warp == 0) {
            for (int i = lane; i < Q; i += 32) cp4(As(s) + i, ab + row + i);
            cp_commit();
        }
    };
    // acs of vector set s from the dtA in stage s (warp 0, which copied that dtA)
    auto cumsum = [&](int s) {
        __syncwarp();  // the lanes copied dtA in another order than they read it
        chunk_cumsum(vecs(s), As(s), Q);
    };
    // the rest of vector set s from its acs, one value a thread: exp(acs_i),
    // exp(last - acs_j) (0 past Q) and exp(last)
    auto exps = [&](int s) {
        float* v = vecs(s);
        const float last = v[Q - 1];
        if (tid < 256) {
            const int i = tid % 128;
            v[128 + tid] = i < Q ? __expf(tid < 128 ? v[i] : last - v[i]) : 0.f;
        } else if (tid == 256) {
            v[384] = __expf(last);
        }
    };

    // G ⊙ L pairs this thread builds: pair u is row (tid % 128) / 8 and column pair
    // tid % 8 of tile 4u + tid / 128
    const int pairs = RT * (RT + 1) / 2 * 128;
    const int prow = (tid & 127) >> 3, pcol = (tid & 7) * 2;
    const int tile0 = tid >> 7;
    float2 gv[kMaxPairs];
    auto load_g = [&](int c) {
        const float* Gc = G + (static_cast<size_t>(b) * n_chunks + c) * Qp * Qp + prow * Qp + pcol;
#pragma unroll
        for (int u = 0; u < kMaxPairs; ++u) {
            const int rk = kTileRK[4 * u + tile0];
            gv[u] = (4 * u + tile0) * 128 < pairs
                ? __ldg(reinterpret_cast<const float2*>(Gc + ((rk & 255) * Qp + (rk >> 8)) * 16))
                : make_float2(0.f, 0.f);
        }
    };

    // rows past Q of both stages stay zero (TMA writes Q rows a box): they meet zero
    // weights, never NaN
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int s = 0; s < 2; ++s) {
        for (int i = tid; i < (Qp - Q) * TP; i += kThreads) Xs(s)[at<TP>(Q + i / TP, i % TP, Qp)] = zero;
        for (int i = tid; i < (Qp - Q) * N; i += kThreads) {
            Bs(s)[at<N>(Q + i / N, i % N, Qp)] = zero;
            Cs(s)[at<N>(Q + i / N, i % N, Qp)] = zero;
        }
    }
    for (int i = tid; i < TP * N; i += kThreads) St[i] = zero;
    if (tid == 0) {
        bar_init(full0, 1);
        bar_init(full0 + 8, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    issue(0, 0);
    if (warp == 0) {
        cp_wait<0>();
        cumsum(0);
    }

    // this warp's slice of the state: rows [sp0, sp0 + 16), 8-column tiles sn0 + u
    const int sp0 = (warp / kWP) * 16;
    const int sn0 = (warp % kWP) * kTPW;
    float st[kTPW][4];
#pragma unroll
    for (int u = 0; u < kTPW; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[u][e] = 0.f;

    // this warp's row tiles of y, rt[rr] (rows [16 rt, 16 rt + 16)), and its 8-column
    // tiles pn0 + n
    int rt[kRT];
    if constexpr (kRT == 2) {
        rt[0] = warp % 4;
        rt[1] = 7 - warp % 4;
    } else {
        rt[0] = warp % 8;
    }
    const int pn0 = (warp / (8 / kRT)) * kPTW;
    const int lr = (lane % 8) + ((lane / 8) % 2) * 8;  // ldmatrix: this lane's row of 16
    const int lc = lane / 16;                            // and 8-column half
    for (int c = 0; c < n_chunks; ++c) {
        const int s = c & 1;
        bar_wait(full0 + 8 * s, (c >> 1) & 1);  // chunk c's x, B and C have landed
        __syncthreads();  // (1) chunk c's x, B, C and acs, and the state copy are in place;
                          // chunk c - 1 is done with stage s ^ 1 and G ⊙ L
        if (c + 1 < n_chunks) issue(s ^ 1, c + 1);
        const bf16* xs = Xs(s);
        const bf16* bs = Bs(s);
        const bf16* cs = Cs(s);
        const float* acs = vecs(s);
        const float* din = acs + 128;
        const float* dout = acs + 256;
        exps(s);
        load_g(c);  // in flight while C·stateᵀ runs

        // C·stateᵀ in bf16 for the warp's rows (C is bf16 as given; the state copy is
        // rounded to bf16, which moves y by far less than y's own rounding)
        float yo[kRT][kPTW][4];
#pragma unroll
        for (int rr = 0; rr < kRT; ++rr)
#pragma unroll
            for (int n = 0; n < kPTW; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) yo[rr][n][e] = 0.f;
#pragma unroll 2
        for (int k0 = 0; k0 < N; k0 += 16) {
            // A: rows [16 rt, 16 rt + 16) of C, columns [k0, k0 + 16)
            uint32_t cf[kRT][4];
#pragma unroll
            for (int rr = 0; rr < kRT; ++rr) {
                const int i0 = rt[rr] * 16 < Qp ? rt[rr] * 16 : 0;  // a tile past Q: any rows
                if constexpr (N >= 16) {
                    ldsm_x4(cf[rr], cs + at<N>(i0 + lr, k0 + lc * 8, Qp));
                } else {
                    uint32_t h2[2];
                    ldsm_x2(h2, cs + at<N>(i0 + lr, k0, Qp));
                    cf[rr][0] = h2[0];
                    cf[rr][1] = h2[1];
                    cf[rr][2] = cf[rr][3] = 0u;
                }
            }
            // B: state rows (pn0 + n)·8 + [0, 8), columns [k0, k0 + 16)
            uint32_t sf[kPTW][2];
            if constexpr (N >= 16 && kPTW == 2) {
                uint32_t q4[4];
                ldsm_x4(q4, St + at<N>((pn0 + lane / 16) * 8 + lane % 8, k0 + ((lane / 8) % 2) * 8, TP));
                sf[0][0] = q4[0]; sf[0][1] = q4[1]; sf[1][0] = q4[2]; sf[1][1] = q4[3];
            } else if constexpr (N >= 16) {
                uint32_t q2[2];
                ldsm_x2(q2, St + at<N>(pn0 * 8 + lane % 8, k0 + ((lane / 8) % 2) * 8, TP));
                sf[0][0] = q2[0]; sf[0][1] = q2[1];
            } else {
#pragma unroll
                for (int n = 0; n < kPTW; ++n) {
                    uint32_t q2[2];
                    ldsm_x2(q2, St + at<N>((pn0 + n) * 8 + lane % 8, 0, TP));
                    sf[n][0] = q2[0];
                    sf[n][1] = 0u;
                }
            }
#pragma unroll
            for (int n = 0; n < kPTW; ++n)
#pragma unroll
                for (int rr = 0; rr < kRT; ++rr) mma_bf16(yo[rr][n], cf[rr], sf[n][0], sf[n][1]);
        }

        // G ⊙ L for the tiles at or below the diagonal, rounded to bf16 once
        {
#pragma unroll
            for (int u = 0; u < kMaxPairs; ++u) {
                const int tile = 4 * u + tile0;
                if (tile * 128 < pairs) {
                    const int rk = kTileRK[tile];
                    const int i = (rk & 255) * 16 + prow, j = (rk >> 8) * 16 + pcol;
                    const float ai = acs[min(i, Q - 1)];
                    const float2 aj = *reinterpret_cast<const float2*>(acs + j);
                    const float l0 = j <= i && i < Q ? __expf(ai - aj.x) : 0.f;
                    const float l1 = j + 1 <= i && i < Q ? __expf(ai - aj.y) : 0.f;
                    const int at_gl = tile * 256 + prow * 16 + ((pcol / 8) ^ ((prow / 4) & 1)) * 8 + pcol % 8;
                    const float v0 = gv[u].x * l0, v1 = gv[u].y * l1;
                    const uint32_t hi = pack_bf16(v0, v1);
                    *reinterpret_cast<uint32_t*>(GL + at_gl) = hi;
                    *reinterpret_cast<uint32_t*>(GL_lo + at_gl) =
                        pack_bf16(v0 - __uint_as_float(lo_bits(hi)), v1 - __uint_as_float(hi_bits(hi)));
                }
            }
        }
        __syncthreads();  // (2) G ⊙ L and the vectors are in place; every read of the state
                          // copy is done

        // state = state · exp(last) + (x ⊙ exp(last - acs))ᵀ·B, the decayed x in TF32;
        // the k index t is chunk row 2t, t + 4 is 2t + 1, which is what ldmatrix.trans
        // hands a thread: rows 2t and 2t + 1 of one column, packed
        const float decay = acs[384];
#pragma unroll
        for (int u = 0; u < kTPW; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) st[u][e] *= decay;
        if (sn0 < kNT) {
            for (int j0 = 0; j0 < Qp; j0 += 16) {
                uint32_t xf[4];  // [j0, cols sp0..], [j0, sp0+8..], [j0+8, sp0..], [j0+8, sp0+8..]
                ldsm_x4_t(xf, xs + (j0 + (lane / 16) * 8 + lane % 8) * TP +
                                  swz<TP / 8>(j0 + (lane / 16) * 8 + lane % 8, sp0 / 8 + (lane / 8) % 2) * 8);
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int ja = j0 + 8 * half + 2 * t;
                    const float da = dout[ja], db = dout[ja + 1];
                    const uint32_t lo = xf[2 * half], hi = xf[2 * half + 1];
                    const uint32_t a0 = tf32(__uint_as_float(lo_bits(lo)) * da);
                    const uint32_t a2 = tf32(__uint_as_float(hi_bits(lo)) * db);
                    const uint32_t a1 = tf32(__uint_as_float(lo_bits(hi)) * da);
                    const uint32_t a3 = tf32(__uint_as_float(hi_bits(hi)) * db);
                    const int jrow = j0 + 8 * half + lane % 8;
#pragma unroll
                    for (int u = 0; u < kTPW; u += (kTPW >= 4 ? 4 : kTPW)) {
                        if constexpr (kTPW >= 4) {
                            uint32_t bf[4];
                            ldsm_x4_t(bf, bs + at<N>(jrow, (sn0 + u + lane / 8) * 8, Qp));
#pragma unroll
                            for (int v = 0; v < 4; ++v)
                                mma_tf32(st[u + v], a0, a1, a2, a3, lo_bits(bf[v]), hi_bits(bf[v]));
                        } else if constexpr (kTPW == 2) {
                            uint32_t bf[2];
                            ldsm_x2_t(bf, bs + at<N>(jrow, (sn0 + (lane / 8) % 2) * 8, Qp));
                            mma_tf32(st[0], a0, a1, a2, a3, lo_bits(bf[0]), hi_bits(bf[0]));
                            mma_tf32(st[1], a0, a1, a2, a3, lo_bits(bf[1]), hi_bits(bf[1]));
                        } else {
                            uint32_t bf;
                            ldsm_x1_t(bf, bs + at<N>(jrow, sn0 * 8, Qp));
                            mma_tf32(st[0], a0, a1, a2, a3, lo_bits(bf), hi_bits(bf));
                        }
                    }
                }
            }
        }


        // the state copy for the next chunk's C·stateᵀ, rounded to bf16 once
#pragma unroll
        for (int u = 0; u < kTPW; ++u) {
            if (sn0 + u >= kNT) continue;
            const int col = (sn0 + u) * 8 + 2 * t;
            *reinterpret_cast<uint32_t*>(St + at<N>(sp0 + g, col, TP)) = pack_bf16(st[u][0], st[u][1]);
            *reinterpret_cast<uint32_t*>(St + at<N>(sp0 + g + 8, col, TP)) = pack_bf16(st[u][2], st[u][3]);
        }

        // y rows of the warp's tiles = (G ⊙ L)·x + (C·stateᵀ) ⊙ exp(acs)
#pragma unroll
        for (int rr = 0; rr < kRT; ++rr) {
            const int r = rt[rr];
            if (r * 16 >= Qp) continue;
            float yd[kPTW][4];
#pragma unroll
            for (int n = 0; n < kPTW; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) yd[n][e] = 0.f;
            for (int kk = 0; kk <= r; ++kk) {
                uint32_t a[4], a_lo[4];
                const int at_a = (r * (r + 1) / 2 + kk) * 256 + lr * 16 + (lc ^ ((lr / 4) & 1)) * 8;
                ldsm_x4(a, GL + at_a);
                ldsm_x4(a_lo, GL_lo + at_a);
                const int jr = kk * 16 + lr;
                if constexpr (kPTW >= 2) {
#pragma unroll
                    for (int n = 0; n < kPTW; n += 2) {
                        uint32_t bf[4];
                        ldsm_x4_t(bf, xs + jr * TP + swz<TP / 8>(jr, pn0 + n + lc) * 8);
                        mma_bf16(yd[n], a, bf[0], bf[1]);
                        mma_bf16(yd[n + 1], a, bf[2], bf[3]);
                        mma_bf16(yd[n], a_lo, bf[0], bf[1]);
                        mma_bf16(yd[n + 1], a_lo, bf[2], bf[3]);
                    }
                } else {
                    uint32_t bf[2];
                    ldsm_x2_t(bf, xs + jr * TP + swz<TP / 8>(jr, pn0) * 8);
                    mma_bf16(yd[0], a, bf[0], bf[1]);
                    mma_bf16(yd[0], a_lo, bf[0], bf[1]);
                }
            }
            const int r0 = r * 16 + g, r1 = r0 + 8;
            const float e0 = din[min(r0, 127)], e1 = din[min(r1, 127)];
#pragma unroll
            for (int n = 0; n < kPTW; ++n) {
                const int col = (pn0 + n) * 8 + 2 * t;
                if (r0 < Q)
                    *reinterpret_cast<uint32_t*>(yb + (static_cast<size_t>(c) * Q + r0) * P + col) =
                        pack_bf16(yd[n][0] + yo[rr][n][0] * e0, yd[n][1] + yo[rr][n][1] * e0);
                if (r1 < Q)
                    *reinterpret_cast<uint32_t*>(yb + (static_cast<size_t>(c) * Q + r1) * P + col) =
                        pack_bf16(yd[n][2] + yo[rr][n][2] * e1, yd[n][3] + yo[rr][n][3] * e1);
            }
        }
        // warp 0 takes the next chunk's cumsum (its dtA copies are its own)
        if (warp == 0 && c + 1 < n_chunks) {
            cp_wait<0>();  // warp 0's dtA copies of chunk c + 1
            cumsum(s ^ 1);
        }
    }
    if (final_state == nullptr) return;
    float* fb = final_state + (bh * P + p0) * N;
#pragma unroll
    for (int u = 0; u < kTPW; ++u) {
        if (sn0 + u >= kNT) continue;
        const int col = (sn0 + u) * 8 + 2 * t;
        *reinterpret_cast<float2*>(fb + (sp0 + g) * N + col) = make_float2(st[u][0], st[u][1]);
        *reinterpret_cast<float2*>(fb + (sp0 + g + 8) * N + col) = make_float2(st[u][2], st[u][3]);
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded; null if absent
EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* sym = nullptr;
        cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym,
                                                        cudaEnableDefault, &found);
#endif
        return err == cudaSuccess && found == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(sym)
                   : nullptr;
    }();
    return fn;
}

// A row-major (rows, cols) bf16 matrix as a 2-D map whose box is (box_cols, box_rows),
// swizzled across box_cols * 2 bytes (128, 64 or 32; none at 16), as `at` expects
cudaError_t make_map(CUtensorMap* map, const void* ptr, int cols, long long rows, int box_cols,
                     int box_rows) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
    const cuuint32_t unit[2] = {1, 1};
    const int span = box_cols * 2;
    const CUtensorMapSwizzle swizzle = span == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : span == 64  ? CU_TENSOR_MAP_SWIZZLE_64B
                                     : span == 32  ? CU_TENSOR_MAP_SWIZZLE_32B
                                                   : CU_TENSOR_MAP_SWIZZLE_NONE;
    const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int N, int TP>
cudaError_t launch(const void* x, const float* dta, const void* bm, const void* cm, void* y,
                   float* final_state, float* scores, int B, int H, int L, int P, int Q,
                   cudaStream_t stream) {
    const int Qp = (Q + 15) / 16 * 16;
    constexpr int kBW = N < 64 ? N : 64;
    CUtensorMap mx, mb, mc;
    cudaError_t err = make_map(&mx, x, P, static_cast<long long>(B) * H * L, TP, Q);
    if (err == cudaSuccess) err = make_map(&mb, bm, N, static_cast<long long>(B) * L, kBW, Q);
    if (err == cudaSuccess) err = make_map(&mc, cm, N, static_cast<long long>(B) * L, kBW, Q);
    if (err != cudaSuccess) return err;
    const int bytes = Smem<N, TP>::bytes(Qp);
    err = cudaFuncSetAttribute(scan_kernel<N, TP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    const bf16* b16 = static_cast<const bf16*>(bm);
    const bf16* c16 = static_cast<const bf16*>(cm);
    const int bytes1 = (16 + Qp) * N * 2;  // 16 rows of C and at most Qp of B
    err = cudaFuncSetAttribute(scores_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes1);
    if (err != cudaSuccess) return err;
    scores_kernel<N><<<dim3(L / Q, B, Qp / 16), kScoreWarps * 32, bytes1, stream>>>(
        b16, c16, scores, L, Q);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    scan_kernel<N, TP><<<dim3(P / TP, H, B), kThreads, bytes, stream>>>(
        mx, mb, mc, dta, scores, static_cast<bf16*>(y), final_state, H, L, P, Q);
    return cudaGetLastError();
}

template <int N>
cudaError_t launch_tp(const void* x, const float* dta, const void* bm, const void* cm, void* y,
                      float* final_state, float* scores, int B, int H, int L, int P, int Q,
                      int tp, cudaStream_t stream) {
    switch (tp) {
        case 16: return launch<N, 16>(x, dta, bm, cm, y, final_state, scores, B, H, L, P, Q, stream);
        case 32: return launch<N, 32>(x, dta, bm, cm, y, final_state, scores, B, H, L, P, Q, stream);
        case 64: return launch<N, 64>(x, dta, bm, cm, y, final_state, scores, B, H, L, P, Q, stream);
        default: return cudaErrorInvalidValue;
    }
}

cudaError_t launch_n(const void* x, const float* dta, const void* bm, const void* cm, void* y,
                     float* final_state, float* scores, int B, int H, int L, int P, int N, int Q,
                     int tp, cudaStream_t stream) {
    if (scores == nullptr) return cudaErrorInvalidValue;
    switch (N) {
        case 8: return launch_tp<8>(x, dta, bm, cm, y, final_state, scores, B, H, L, P, Q, tp, stream);
        case 16: return launch_tp<16>(x, dta, bm, cm, y, final_state, scores, B, H, L, P, Q, tp, stream);
        case 32: return launch_tp<32>(x, dta, bm, cm, y, final_state, scores, B, H, L, P, Q, tp, stream);
        case 64: return launch_tp<64>(x, dta, bm, cm, y, final_state, scores, B, H, L, P, Q, tp, stream);
        case 128: return launch_tp<128>(x, dta, bm, cm, y, final_state, scores, B, H, L, P, Q, tp, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace tc
}  // namespace

// x (B,H,L,P), dta (B,H,L) f32, bm/cm (B,L,N), y (B,H,L,P) in x's type, all contiguous;
// final_state (B,H,P,N) f32, or null for none. dtype: 0 = float32 (the SIMT kernel, one
// launch), 2 = bfloat16 (the tensor-core pair, two launches; x, bm and cm 16-byte
// aligned, and `scores` f32 scratch of B * (L/Q) * Qp * Qp floats, Qp = Q rounded up to
// 16; the float32 path takes null there). N in {8, 16, 32, 64, 128}; tp (state rows a
// block owns) in {16, 32, 64}, dividing P; 1 <= Q <= 128 and L a multiple of Q. Returns
// the cudaError_t of the launches (0 = cudaSuccess); cudaErrorInvalidValue for anything
// else.
extern "C" int ssd_scan_launch(const void* x, const void* dta, const void* bm, const void* cm,
                               void* y, void* final_state, void* scores, int B, int H, int L,
                               int P, int N, int Q, int tp, int dtype, void* stream) {
    if (B <= 0 || H <= 0 || L <= 0 || P <= 0) return cudaSuccess;
    if (Q < 1 || Q > kMaxQ || L % Q != 0 || tp <= 0 || P % tp != 0) return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* a = static_cast<const float*>(dta);
    float* fs = static_cast<float*>(final_state);
    switch (dtype) {
        case 0: return static_cast<int>(
            launch_n<float>(x, a, bm, cm, y, fs, B, H, L, P, N, Q, tp, st));
        case 2: return static_cast<int>(
            tc::launch_n(x, a, bm, cm, y, fs, static_cast<float*>(scores), B, H, L, P, N, Q, tp, st));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
