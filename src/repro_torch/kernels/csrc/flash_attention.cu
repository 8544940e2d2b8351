// Causal / sliding-window GQA attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention_fwd
// (Pallas; grid (B, H, q blocks, kv blocks) with the kv-block axis sequential and
// the online-softmax state carried in VMEM scratch). The semantics are the TPU
// kernel's: scores and softmax in f32, masks with -1e30 (not -inf), causal means
// kpos <= qpos with both counted from 0, window > 0 adds kpos > qpos - window, q
// head h reads KV head h / (H / KV), and the output is acc / max(l, 1e-30) rounded
// once to q's type. Sq and Sk may be any length and may differ. Head widths come in
// (q·k, v) pairs: (32, 32), (64, 64), (128, 128) and (256, 256) for the dense
// models, (112, 112) for Kimi-K2 (64 heads over 8 KV heads of 7168 / 64), and
// (192, 128) for DeepSeek-V3's MLA prefill, whose q and k are the 128-wide no-RoPE
// part and the 64-wide RoPE part concatenated and whose v is 128 wide. The SIMT
// kernel takes each width as it is (multiples of 16). The tensor-core kernel holds a
// width in whole 64-column boxes: 112 is loaded through a tensor map 112 wide as two
// boxes, TMA zero-fills columns 112-127, S = Q·Kᵀ runs the 7 k16 steps that hold
// data, P·V runs at 128 and the zero columns are not stored.
// flash_attention_launch dispatches by dtype to one of two kernels. Both
// can also write each row's log-sum-exp, m + ln l in f32, through an optional
// pointer: the training forward asks for it, since the backward
// (flash_attention_bwd.cu) rebuilds P from it; serving passes null. The bf16
// kernel can also write the output before its rounding, in f32, through a second
// optional pointer: the backward's D = rowsum(dO ∘ O) needs O to f32 precision.
// From the rounded O, D is off by up to 2^-9 of |dO||O|, and dQ = Σ P(dP − D)K
// carries that error times the attention-weighted mean key, which the true dQ
// does not contain; where keys share a large common part and the softmax spreads
// over many keys (whisper's encoder states) that error outgrows the true dQ.
//
// bfloat16: flash_attention_tc, on the tensor cores. What bounds it: at a long
// prompt (q (1,16,4096,128)) the causal products are ~69 GFLOP against 50 MB of
// q/k/v/o, so it is bound by operations (989 TFLOP/s bf16); at the serving
// prefill (q (8,16,576,128)) it is bound by bytes (57 MB at 3.35 TB/s, above its
// 11 GFLOP). The design, FlashAttention-3's shape without its later refinements:
//   * one CTA per (q tile of 128 rows, q head, batch): two consumer warpgroups of
//     64 rows each and one producer warp; the CTAs of the last (heaviest causal)
//     q tiles start first, so the causal imbalance leaves no tail wave;
//   * operations: S = Q·Kᵀ and O += P·V run as wgmma.mma_async m64nNk16 (bf16 in,
//     f32 accumulators in registers). S reads Q and K from shared memory, both
//     K-major; P·V takes P from registers (the m64 accumulator layout of S is the
//     register A layout once converted to bf16 in place) and V from shared memory
//     as it lies, hd-contiguous, through wgmma's transpose bit for 16-bit B;
//   * bytes: the producer warp TMA-loads Q once and each K/V tile of 128 rows into
//     a 2-stage ring in shared memory, with an mbarrier per stage for "full" (TMA
//     transaction bytes) and one for "empty" (one arrival per consumer warpgroup
//     once its P·V wgmma has retired), so the next tile's load overlaps this
//     tile's products. A CTA reads its Q tile and each K/V tile it visits once;
//     the K/V tiles that other q tiles of the head and the other q heads of a
//     GQA group read again come from L2. Tensor maps are 3-D
//     (hd, S, B·heads), so rows past Sq or Sk are zero-filled by TMA inside their
//     own head. 128-byte swizzle (64-byte at hd 32) keeps wgmma's shared-memory
//     reads free of bank conflicts; a 256-byte row (hd 128) loads as two boxes of
//     64 columns;
//   * online softmax in the accumulator layout: a thread holds parts of 2 rows;
//     row max and row sum reduce across the 4 threads of a quad; scale·log2(e) is
//     folded into exp2. Masks are built only on tiles that cross the diagonal, the
//     window edge or Sk, and tiles wholly outside them are not visited. A row whose
//     first visited tile is fully masked (the window case) gets p = 1 there, as on
//     the TPU, until a live key makes alpha = exp(-1e30 - m) = 0;
//   * one deliberate difference from f32: the tensor core takes P in bf16, so P
//     is rounded to bf16 for the P·V product (l sums the f32 values). That adds at
//     most about 2^-9 · max|v| to an output, inside the bf16 tolerance of 2e-2.
//     Training (o32 given) runs a second P·V product with the remainder P − bf16(P),
//     also in bf16 and in the same wgmma group as the first, in an instance of the
//     kernel of its own (serving's keeps its registers and its code), so O carries
//     P to about 2^-16: the backward's D = rowsum(dO ∘ O) must be the sum of P·dP
//     over the P it rebuilds in f32, or dQ gets D's error times the attention-
//     weighted mean key, which the true dQ does not contain (whisper's encoder
//     states share a large common part). The f32 accumulator of bf16(P)·V alone
//     is not enough: on keys 3× their spread off a common vector its dQ missed
//     the bf16 tolerance by up to 1.6× on the card, where this design holds it.
//   Shared memory at hd 128: Q 32 KB + 2 stages × (K + V) 64 KB = 160 KB, one CTA
//   per SM. K/V tiles are 128 rows up to hd 128: registers hold S (64 f32), O (up to
//   64 f32) and P (32 words) per thread, within the 168 that 288 threads allow.
//   At hd 256 (gemma3) a K or V tile of 128 rows is 64 KB, and Q and a 2-stage ring
//   would need 320 KB of the 227 the card has, so K/V tiles are 64 rows there: Q
//   64 KB + 2 × (K 32 KB + V 32 KB) = 192 KB. A thread then holds O (128 f32), S
//   (32 f32) and P (16 words); S = Q·Kᵀ runs as m64n64k16 and P·V as two m64n128k16
//   halves of the 256 output columns (a 512-byte row is four boxes of 64 columns).
//   That is more than the 168 registers a thread of a 288-thread CTA can have (nine
//   warps put three on one of the SM's four register files), so at hd 256 the
//   producer is a whole warpgroup (384 threads) that gives its registers up
//   (setmaxnreg: 24 a thread) and the two consumer warpgroups take 240 each, as
//   FlashAttention-3 does.
//
// float32: flash_attention_kernel, on the f32 SIMT pipes (its ceiling is the card's
// 67 TFLOP/s of f32): on the tensor cores f32 would run as TF32 and miss the f32
// tolerance of 2e-5. The serving model is bf16. Its design:
//   * one block of 128 threads per (q tile of 64 rows, q head, batch); KV head is
//     h / (H / KV), so a group's q heads read the same K/V (from L2). At hd 256 the
//     q tile is 32 rows (4 a thread), so that the output accumulator (64 f32) and a
//     4-key slice of V (64 f32) stay in registers;
//   * the block walks K/V tiles of 32 rows in order, as the TPU grid did, staging
//     Q once and each K/V tile through shared memory;
//   * thread (ty, tx) = (tid / 16, tid % 16) owns q rows ty*8 .. ty*8+7 (hd 256:
//     ty*4 .. ty*4+3): the
//     scores of columns tx and tx+16 of each tile, and output columns tx + 16*j;
//     row max and row sum reduce across the 16 lanes of a half warp by shuffles;
//   * running m, l and the output accumulator stay in f32 registers;
//   * tiles wholly above the causal diagonal or wholly outside the window are not
//     visited (the TPU kernel visits them and they contribute exactly zero);
//   * Sq and Sk need not be multiples of the tiles: rows past the end load as
//     zeros, are masked as keys and are not stored as queries;
//   * Q and K rows are padded by 4 floats in shared memory, so the float4 reads of
//     16 different K rows by one half warp fall in distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"  // mbarriers, TMA, wgmma, tensor maps (shared with the backward)

namespace {
namespace simt {


constexpr int kBK = 32;        // k rows per tile
constexpr int kThreads = 128;  // 8 row groups x 16 lanes
constexpr int kCols = kBK / 16;  // score columns per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load8(const float* __restrict__ p, float* v) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

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

// DK: the q·k width, DV: v's and the output's (equal but for MLA's 192/128)
template <int DK, int DV>
struct Smem {
    static constexpr int kRows = DV >= 256 ? 4 : 8;  // q rows per thread
    static constexpr int kBQ = 8 * kRows;            // q rows per block
    static constexpr int kLdQ = DK + 4;
    static constexpr int kLdK = DK + 4;
    static constexpr int kLdV = DV;
    static constexpr int kLdP = kBK + 4;
    static constexpr int kFloats = kBQ * kLdQ + kBK * kLdK + kBK * kLdV + kBQ * kLdP;
    static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                       int H, int KV, int Sq, int Sk, int causal, int window, float scale) {
    using L = Smem<DK, DV>;
    constexpr int kRows = L::kRows;
    constexpr int kBQ = L::kBQ;
    constexpr int kOut = DV / 16;  // output columns per thread
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

    const T* qb = q + (static_cast<size_t>(b) * H + h) * Sq * DK;
    const T* kb = k + (static_cast<size_t>(b) * KV + kvh) * Sk * DK;
    const T* vb = v + (static_cast<size_t>(b) * KV + kvh) * Sk * DV;
    T* ob = o + (static_cast<size_t>(b) * H + h) * Sq * DV;

    const int q_valid = min(kBQ, Sq - q0);
    stage<T, DK, kBQ, L::kLdQ>(Qs, qb + static_cast<size_t>(q0) * DK, q_valid);
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
        stage<T, DK, kBK, L::kLdK>(Ks, kb + static_cast<size_t>(k0) * DK, k_valid);
        stage<T, DV, kBK, L::kLdV>(Vs, vb + static_cast<size_t>(k0) * DV, k_valid);
        __syncthreads();

        // scores s[i][j] of row ty*8+i against key column tx + 16*j
        float s[kRows][kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < DK; d += 4) {
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
            store1(ob + static_cast<size_t>(q0 + r) * DV + tx + 16 * j, acc[i][j] * inv);
        // m and l are the same in the 16 lanes of the row
        if (lse != nullptr && tx == 0)
            lse[(static_cast<size_t>(b) * H + h) * Sq + q0 + r] = m[i] + logf(l[i]);
    }
}

template <typename T, int DK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int H, int KV, int Sq, int Sk, int causal, int window, float scale,
                   cudaStream_t stream) {
    constexpr size_t bytes = Smem<DK, DV>::kBytes;
    // above 48 KiB of dynamic shared memory a kernel must opt in, once per process;
    // every call sets it again: the call is cheap next to the kernel and has no race
    cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, DK, DV>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    const dim3 grid((Sq + Smem<DK, DV>::kBQ - 1) / Smem<DK, DV>::kBQ, H, B);
    flash_attention_kernel<T, DK, DV><<<grid, kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse, H, KV, Sq, Sk, causal, window, scale);
    return cudaGetLastError();
}

// the (q·k, v) width pairs of flash_attention.py's HEAD_DIMS
template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                      int H, int KV, int Sq, int Sk, int dk, int dv, int causal, int window,
                      float scale, cudaStream_t stream) {
#define PAIR(DK, DV)                                                                     \
    if (dk == DK && dv == DV)                                                           \
        return launch<T, DK, DV>(q, k, v, o, lse, B, H, KV, Sq, Sk, causal, window, scale, \
                                 stream)
    PAIR(32, 32); PAIR(64, 64); PAIR(112, 112); PAIR(128, 128); PAIR(192, 128); PAIR(256, 256);
#undef PAIR
    return cudaErrorInvalidValue;
}

}  // namespace simt

namespace tc {

using namespace sm90;

constexpr int kBQ = 128;                 // q rows per CTA
constexpr int kStages = 2;               // K/V ring depth
constexpr int kConsumers = 2;            // warpgroups of 64 q rows
constexpr int kProducerRegs = 24;        // a producer thread's registers after setmaxnreg
constexpr float kMask = -1e30f;          // the TPU kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory layout for q·k width DK and v width DV, each tile as TMA writes it
// (sm90.cuh, Tile, at the padded widths KP and VP): Q | K[kStages] | V[kStages] |
// mbarriers. K/V tiles are 128 rows, 64 at v width 256 (a 128-row ring would not
// fit in shared memory). At (192, 128), MLA's prefill: Q 48 KB + 2 × (K 48 KB + V
// 32 KB) = 208 KB; registers as at hd 128 (O is 128 wide).
template <int DK, int DV>
struct Cfg {
    static constexpr int KP = padded(DK);
    static constexpr int VP = padded(DV);
    static constexpr int kBK = VP >= 256 ? 64 : 128;  // k/v rows per tile
    // the consumers and the producer: one warp, or at hd 256 a warpgroup whose
    // registers go to the consumers (kConsumerRegs a thread; 0: no setmaxnreg)
    static constexpr int kThreads = kConsumers * 128 + (VP >= 256 ? 128 : 32);
    static constexpr int kConsumerRegs = VP >= 256 ? 240 : 0;
    static constexpr int kQBytes = Tile<KP>::bytes(kBQ);
    static constexpr int kKBytes = Tile<KP>::bytes(kBK);
    static constexpr int kVBytes = Tile<VP>::bytes(kBK);
    static constexpr int kOffK = kQBytes;
    static constexpr int kOffV = kOffK + kStages * kKBytes;
    static constexpr int kOffBar = kOffV + kStages * kVBytes;
    static constexpr int kBars = 1 + 3 * kStages;  // q_full, k_full[], v_full[], empty[]
    static constexpr size_t kBytes = kOffBar + 8 * kBars + 1024;  // + room to align to 1024
};

// kF32Out: the training instance, which also writes O in f32 through o32 (see
// above); serving instantiates the kernel without it, so the second product and
// its registers cost serving nothing.
template <int DK, int DV, bool kF32Out>
__global__ void __launch_bounds__(Cfg<DK, DV>::kThreads, 1)
flash_attention_tc(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                   float* __restrict__ lse, float* __restrict__ o32, int H, int KV, int Sq,
                   int Sk, int causal,
                   int window, float scale_log2) {
    using C = Cfg<DK, DV>;
    using TK = Tile<C::KP>;
    using TV = Tile<C::VP>;
    constexpr int KP = C::KP, VP = C::VP;
    constexpr int kBK = C::kBK;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;  // swizzle atoms need 1024
    const uint32_t sQ = base;
    const uint32_t sK = base + C::kOffK;
    const uint32_t sV = base + C::kOffV;
    const uint32_t q_full = base + C::kOffBar;
    auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
    auto v_full = [&](int s) { return q_full + 8 * (1 + kStages + s); };
    auto empty = [&](int s) { return q_full + 8 * (1 + 2 * kStages + s); };

    // The grid is (q tiles, H, B); CTAs start in linear order, so the linear index
    // is mapped to the last q tiles (the most K/V tiles under a causal mask) first.
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
    if (warp >= kConsumers * 4) {
        // producer: one thread issues every load
        if constexpr (C::kConsumerRegs > 0)
            asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(kProducerRegs));
        if (warp != kConsumers * 4 || lane != 0 || n_visit == 0) return;
        // every box counts its full bytes, zero-filled rows and columns included
        bar_expect_tx(q_full, C::kQBytes);
#pragma unroll
        for (int x = 0; x < TK::kBoxes; ++x)
            tma_load(sQ + x * TK::box(kBQ), &tm_q, q_full, x * TK::kBoxCols, q0, bh);
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
    if constexpr (C::kConsumerRegs > 0)
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(C::kConsumerRegs));
    const int wg = warp / 4;
    if (wg >= n_active) return;
    const int wg_lo = q0 + 64 * wg;
    const int wg_hi = min(wg_lo + 63, Sq - 1);
    const int row0 = wg_lo + 16 * (warp % 4) + lane / 4;  // this thread's rows: row0, row0 + 8
    const int col = 2 * (lane % 4);  // and, in each group of 8 columns, col and col + 1

    // accumulator layout of wgmma m64nN: register 4j + 2r + e holds row row0 + 8r,
    // column 8j + col + e
    float acc[VP / 2];
    float s[kBK / 2];
    uint32_t p[kBK / 4];
#pragma unroll
    for (int i = 0; i < VP / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
    float m[2] = {kMask, kMask};  // running max, in log2 units
    float l[2] = {0.f, 0.f};      // this thread's share of the running sum

    if (n_visit > 0) bar_wait(q_full, 0);
    for (int i = 0; i < n_visit; ++i) {
        const int st = i % kStages;
        const int parity = (i / kStages) & 1;
        const int k0 = (t_lo + i) * kBK;

        // S = Q Kᵀ: DK/16 steps of k16 (the zero columns of a padded width are
        // skipped), both operands K-major
        bar_wait(k_full(st), parity);
        pin(s);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < DK / 16; ++ks)
            mma_ss<kBK>(s, desc_k<KP>(sQ, kBQ, 64 * wg, ks),
                        desc_k<KP>(sK + st * C::kKBytes, kBK, 0, ks), ks > 0);
        wgmma_commit();
        wgmma_wait_all();
        pin(s);

        // scale into log2 units; mask only where the tile crosses Sk, the diagonal
        // or the window edge for some row of this warpgroup
        const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > wg_lo) ||
                          (window > 0 && k0 <= wg_hi - window);
        if (edge) {
#pragma unroll
            for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
                for (int r = 0; r < 2; ++r)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int kpos = k0 + 8 * j + col + e;
                        const int qpos = row0 + 8 * r;
                        bool ok = kpos < Sk;
                        if (causal) ok = ok && kpos <= qpos;
                        if (window > 0) ok = ok && kpos > qpos - window;
                        float& x = s[4 * j + 2 * r + e];
                        x = ok ? x * scale_log2 : kMask;
                    }
        } else {
#pragma unroll
            for (int i2 = 0; i2 < kBK / 2; ++i2) s[i2] *= scale_log2;
        }

        // online softmax, rows row0 and row0 + 8
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float mx = m[r];
#pragma unroll
            for (int j = 0; j < kBK / 8; ++j)
                mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float alpha = exp2_approx(m[r] - mx);
            m[r] = mx;
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float& x = s[4 * j + 2 * r + e];
                    x = exp2_approx(x - mx);
                    sum += x;
                }
            l[r] = l[r] * alpha + sum;
#pragma unroll
            for (int j = 0; j < VP / 8; ++j) {
                acc[4 * j + 2 * r] *= alpha;
                acc[4 * j + 2 * r + 1] *= alpha;
            }
        }
        // P in bf16 as wgmma's register A operand: for keys 16kk..16kk+15 the four
        // words are the consecutive pairs of s[8kk .. 8kk+7]. Training (kF32Out) also
        // packs the remainder P − bf16(P), the part P lost, for a second product
        // issued in the same group: S dies here, so the two packed halves take its
        // registers and nothing stays live across the products.
        uint32_t p_lo[kF32Out ? kBK / 4 : 1];
#pragma unroll
        for (int i2 = 0; i2 < kBK / 4; ++i2) {
            p[i2] = pack_bf16(s[2 * i2], s[2 * i2 + 1]);
            if constexpr (kF32Out) {
                const float2 hi = unpack_bf16(p[i2]);
                p_lo[i2] = pack_bf16(s[2 * i2] - hi.x, s[2 * i2 + 1] - hi.y);
            }
        }

        // O += P V (and, training, + (P − bf16(P)) V): kBK/16 steps of 16 keys each;
        // V is hd-contiguous, read MN-major; one commit, one wait
        bar_wait(v_full(st), parity);
        pin(acc);
        pin(p);
        if constexpr (kF32Out) pin(p_lo);
        wgmma_fence();
        const uint32_t tV = sV + st * C::kVBytes;
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
            mma_pv<VP>(acc, &p[4 * kk], desc_mn<VP>(tV, kBK, kk), desc_mn<VP>(tV, kBK, kk, 2));
        if constexpr (kF32Out) {
#pragma unroll
            for (int kk = 0; kk < kBK / 16; ++kk)
                mma_pv<VP>(acc, &p_lo[4 * kk], desc_mn<VP>(tV, kBK, kk),
                           desc_mn<VP>(tV, kBK, kk, 2));
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(acc);
        pin(p);
        if constexpr (kF32Out) pin(p_lo);
        if (threadIdx.x % 128 == 0) bar_arrive(empty(st));  // this warpgroup is done with the stage
    }

    // epilogue: O / max(l, 1e-30), rounded once to bf16 (and, where o32 is given, in
    // f32 as well); rows past Sq, and the columns of a padded width past DV, are not
    // stored
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float lr = l[r];
        lr += __shfl_xor_sync(0xffffffffu, lr, 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        const int qpos = row0 + 8 * r;
        if (qpos >= Sq) continue;
        // m is in log2 units and the same in the quad: one thread writes the
        // natural-log LSE, m·ln 2 + ln l
        if (lse != nullptr && lane % 4 == 0)
            lse[static_cast<size_t>(bh) * Sq + qpos] = (m[r] + log2f(lr)) * kLn2;
        const float denom = fmaxf(lr, 1e-30f);
        const size_t at = (static_cast<size_t>(bh) * Sq + qpos) * DV + col;
#pragma unroll
        for (int j = 0; j < DV / 8; ++j) {
            const float x0 = acc[4 * j + 2 * r] / denom, x1 = acc[4 * j + 2 * r + 1] / denom;
            *reinterpret_cast<__nv_bfloat162*>(o + at + 8 * j) = __floats2bfloat162_rn(x0, x1);
            if constexpr (kF32Out)
                *reinterpret_cast<float2*>(o32 + at + 8 * j) = make_float2(x0, x1);
        }
    }
}

template <int DK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   float* o32, int B, int H, int KV, int Sq, int Sk, int causal, int window,
                   float scale, cudaStream_t stream) {
    using C = Cfg<DK, DV>;
    // with Sk = 0 no K/V tile is visited; the maps must still encode, so they
    // describe q, and no load is issued through them
    const bool any_k = Sk > 0;
    CUtensorMap mq, mk, mv;
    cudaError_t err = bind_device_of(q);  // the encoder needs a current context
    // the maps are the tensors' own widths; a box that runs past one is zero-filled
    if (err == cudaSuccess)
        err = make_map(&mq, q, DK, Sq, B * H, Tile<C::KP>::kBoxCols, kBQ);
    if (err == cudaSuccess)
        err = make_map(&mk, any_k ? k : q, DK, any_k ? Sk : Sq, any_k ? B * KV : B * H,
                       Tile<C::KP>::kBoxCols, C::kBK);
    if (err == cudaSuccess)
        err = any_k ? make_map(&mv, v, DV, Sk, B * KV, Tile<C::VP>::kBoxCols, C::kBK)
                    : make_map(&mv, q, DK, Sq, B * H, Tile<C::KP>::kBoxCols, C::kBK);
    if (err != cudaSuccess) return err;
    // the training instance (o32) at every pair: the backward takes them all in bf16
    // (flash_attention.py: BWD_HEAD_DIMS)
    auto kernel = flash_attention_tc<DK, DV, false>;
    if (o32 != nullptr) kernel = flash_attention_tc<DK, DV, true>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(C::kBytes));
    if (err != cudaSuccess) return err;
    const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
    kernel<<<grid, C::kThreads, C::kBytes, stream>>>(
        mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, o32, H, KV, Sq, Sk, causal, window,
        scale * kLog2e);
    return cudaGetLastError();
}

// the (q·k, v) width pairs of flash_attention.py's HEAD_DIMS
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o, float* lse,
                      float* o32, int B, int H, int KV, int Sq, int Sk, int dk, int dv,
                      int causal, int window, float scale, cudaStream_t stream) {
#define PAIR(DK, DV)                                                                        \
    if (dk == DK && dv == DV)                                                              \
        return launch<DK, DV>(q, k, v, o, lse, o32, B, H, KV, Sq, Sk, causal, window, scale, \
                              stream)
    PAIR(32, 32); PAIR(64, 64); PAIR(112, 112); PAIR(128, 128); PAIR(192, 128); PAIR(256, 256);
#undef PAIR
    return cudaErrorInvalidValue;
}

}  // namespace tc
}  // namespace

// q (B,H,Sq,dk), k (B,KV,Sk,dk), v (B,KV,Sk,dv), o (B,H,Sq,dv), all contiguous and
// 16-byte aligned. lse: null, or (B,H,Sq) float32 that receives each row's
// log-sum-exp of its scaled, masked scores (natural log), which the backward
// (flash_attention_bwd.cu) reads. o32: null, or for bfloat16 a
// (B,H,Sq,dv) float32 that receives the output before its rounding to bf16, whose D
// the backward reads; float32 takes null (o is it). dtype: 0 = float32 (the SIMT
// kernel), 2 = bfloat16 (the tensor-core kernel). (dk, dv) in {(32, 32), (64, 64),
// (112, 112), (128, 128), (192, 128), (256, 256)}; H a multiple of KV. Returns the
// cudaError_t of the launch (0 = cudaSuccess); cudaErrorInvalidValue for an
// unsupported dtype or width pair, or a tensor map the driver refuses;
// cudaErrorNotSupported if the driver has no cuTensorMapEncodeTiled.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int H, int KV, int Sq, int Sk, int dk, int dv,
                                      int dtype, int causal, int window, float scale,
                                      void* lse, void* o32, void* stream) {
    if (B <= 0 || H <= 0 || Sq <= 0) return cudaSuccess;
    if (KV <= 0 || H % KV != 0 || Sk < 0) return cudaErrorInvalidValue;
    if (o32 != nullptr && dtype != 2) return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return static_cast<int>(
            simt::launch_hd<float>(q, k, v, o, static_cast<float*>(lse), B, H, KV, Sq, Sk, dk,
                                   dv, causal, window, scale, st));
        case 2: return static_cast<int>(
            tc::launch_hd(q, k, v, o, static_cast<float*>(lse), static_cast<float*>(o32), B, H,
                          KV, Sq, Sk, dk, dv, causal, window, scale, st));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
