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
// shared by all heads (n_groups 1). Everything is computed in f32, the mask is applied
// before the exp (-1e9 above the diagonal, as the TPU kernel does), y is rounded once
// to x's type, and the final state is written in f32 on request.
//
// What bounds it on this card: bytes. Each (b, h) reads its x, dtA and the shared B
// and C once and writes y; the operations this input needs (C·Bᵀ once per (b, chunk),
// three products per (b, h, chunk)) take less time at the card's peak than the bytes
// at 3.35 TB/s. This first version runs every product on the f32 SIMT pipes and
// recomputes C·Bᵀ for every head, so it does about twice the needed operations at a
// fifteenth of the tensor cores' rate, and is bound by those in practice; tensor
// cores (mma.sync / wgmma), TMA and sharing C·Bᵀ across heads are later steps.
// The design:
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

}  // namespace

// x (B,H,L,P), dta (B,H,L) f32, bm/cm (B,L,N), y (B,H,L,P) in x's type, all contiguous;
// final_state (B,H,P,N) f32, or null for none. dtype: 0 = float32, 2 = bfloat16 (x, bm,
// cm and y). N in {8, 16, 32, 64, 128}; tp (state rows a block owns) in {16, 32, 64},
// dividing P; 1 <= Q <= 128 and L a multiple of Q. Returns the cudaError_t of the launch
// (0 = cudaSuccess); cudaErrorInvalidValue for anything else.
extern "C" int ssd_scan_launch(const void* x, const void* dta, const void* bm, const void* cm,
                               void* y, void* final_state, int B, int H, int L, int P, int N,
                               int Q, int tp, int dtype, void* stream) {
    if (B <= 0 || H <= 0 || L <= 0 || P <= 0) return cudaSuccess;
    if (Q < 1 || Q > kMaxQ || L % Q != 0 || tp <= 0 || P % tp != 0) return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* a = static_cast<const float*>(dta);
    float* fs = static_cast<float*>(final_state);
    switch (dtype) {
        case 0: return static_cast<int>(
            launch_n<float>(x, a, bm, cm, y, fs, B, H, L, P, N, Q, tp, st));
        case 2: return static_cast<int>(
            launch_n<__nv_bfloat16>(x, a, bm, cm, y, fs, B, H, L, P, N, Q, tp, st));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
