// GQA decode attention (one query token per sequence against the KV cache), forward,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:decode_attention_fwd
// (Pallas; grid (B, KV, S blocks) with the S-block axis sequential, the online-
// softmax state of the whole q-head group in VMEM scratch, and pos scalar-
// prefetched). Semantics are the TPU kernel's: f32 inside, positions <= pos live,
// window > 0 adds kpos > pos - window, output acc / max(l, 1e-30) in q's type.
//
// What bounds it on this card: bytes. Every live K and V row is read once and used
// for g dot products and g axpys, about 2g operations per byte, far below the
// card's ratio, so the least time is the live cache bytes over 3.35 TB/s. The TPU
// walks S in order on one core; here that would leave one block per (b, kv head),
// 64 blocks on 132 SMs at the serving path's B = 8, KV = 8. So the design splits S
// (flash-decoding):
//   * kernel 1, one block of 128 threads per (S split, kv head x head chunk, b).
//     A block serves G query heads of the group (G = the largest of 8, 4, 2, 1 that
//     divides g), so each K/V row is read once per G heads. A "team" of hd/8 lanes
//     owns one key at a time: each lane loads 8 elements of the K row and of the V
//     row as one 16-byte vector (bf16) or two (f32), the g dot products reduce
//     across the team by shuffles, and each lane keeps its 8 output columns of the
//     g accumulators and running (m, l) in f32 registers. Teams stride over the
//     split's keys; then the block folds its teams' states in shared memory and
//     writes one partial (m, l, acc) per head and split;
//   * kernel 2 folds the partials of all splits, one block per (b, q head);
//   * pos is read from a device int32 by both kernels, never passed from the host,
//     so a decode step issues no host sync. Split bounds are fixed by S, not by pos:
//     splits wholly past pos (or before the window) visit no key and write an empty
//     partial (l = 0), which the fold skips. Rows past pos are never read, so they
//     may hold anything.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

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

// live key range [lo, hi] of the cache for this pos (hi < lo: none)
__device__ __forceinline__ void live_range(int pos, int S, int window, int* lo, int* hi) {
    *lo = (window > 0 && pos - window + 1 > 0) ? pos - window + 1 : 0;
    *hi = pos < S - 1 ? pos : S - 1;
}

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos_ptr,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int KV, int g, int S, int chunk, int nsplit, int window, float scale) {
    constexpr int kLanes = HD / 8;             // lanes per team (one key at a time)
    constexpr int kTeams = kThreads / kLanes;  // keys in flight per block
    __shared__ float sm_m[kTeams][G];
    __shared__ float sm_l[kTeams][G];
    __shared__ float sm_acc[kTeams][G][HD];

    const int split = blockIdx.x;
    const int chunks = g / G;
    const int kvh = blockIdx.y / chunks;
    const int head0 = (blockIdx.y % chunks) * G;
    const int b = blockIdx.z;
    const int lane = threadIdx.x % kLanes;
    const int team = threadIdx.x / kLanes;

    int lo, hi;
    live_range(__ldg(pos_ptr), S, window, &lo, &hi);
    const int s0 = max(lo, split * chunk);
    const int s1 = min(hi + 1, (split + 1) * chunk);  // keys [s0, s1)

    const size_t bk = static_cast<size_t>(b) * KV + kvh;
    const T* kb = k + bk * S * HD + lane * 8;
    const T* vb = v + bk * S * HD + lane * 8;

    float qr[G][8];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) load8(q + (bk * g + head0 + gi) * HD + lane * 8, qr[gi]);

    float m[G], l[G], acc[G][8];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
        m[gi] = -INFINITY;
        l[gi] = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[gi][e] = 0.f;
    }

    // The loop bound is the same for every lane of the block (the shuffles need
    // whole warps); each team takes keys base + team and base + team + kTeams, and
    // a key past the split is loaded from nowhere and leaves the state alone.
    for (int base = s0; base < s1; base += 2 * kTeams) {
        int keys[2] = {base + team, base + team + kTeams};
        float kr[2][8], vr[2][8];
#pragma unroll
        for (int u = 0; u < 2; ++u) {  // both rows' loads before any arithmetic
#pragma unroll
            for (int e = 0; e < 8; ++e) kr[u][e] = vr[u][e] = 0.f;
            if (keys[u] < s1) {
                load8(kb + static_cast<size_t>(keys[u]) * HD, kr[u]);
                load8(vb + static_cast<size_t>(keys[u]) * HD, vr[u]);
            }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const bool live = keys[u] < s1;
#pragma unroll
            for (int gi = 0; gi < G; ++gi) {
                float s = 0.f;
#pragma unroll
                for (int e = 0; e < 8; ++e) s = fmaf(qr[gi][e], kr[u][e], s);
#pragma unroll
                for (int off = kLanes / 2; off > 0; off >>= 1)
                    s += __shfl_xor_sync(0xffffffffu, s, off);
                if (!live) continue;
                s *= scale;
                const float m_new = fmaxf(m[gi], s);
                const float alpha = expf(m[gi] - m_new);  // 0 on the first key (m = -inf)
                const float p = expf(s - m_new);
                l[gi] = l[gi] * alpha + p;
                m[gi] = m_new;
#pragma unroll
                for (int e = 0; e < 8; ++e) acc[gi][e] = fmaf(p, vr[u][e], acc[gi][e] * alpha);
            }
        }
    }

#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
        if (lane == 0) {
            sm_m[team][gi] = m[gi];
            sm_l[team][gi] = l[gi];
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) sm_acc[team][gi][lane * 8 + e] = acc[gi][e];
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
        const int gi = idx / HD;
        const int d = idx % HD;
        float M = -INFINITY;
        for (int t = 0; t < kTeams; ++t)
            if (sm_l[t][gi] > 0.f) M = fmaxf(M, sm_m[t][gi]);
        float Lsum = 0.f, A = 0.f;
        for (int t = 0; t < kTeams; ++t) {
            if (sm_l[t][gi] > 0.f) {
                const float w = expf(sm_m[t][gi] - M);
                Lsum = fmaf(sm_l[t][gi], w, Lsum);
                A = fmaf(sm_acc[t][gi][d], w, A);
            }
        }
        const size_t p = (bk * g + head0 + gi) * nsplit + split;
        part_acc[p * HD + d] = A;
        if (d == 0) {
            part_ml[2 * p] = M;
            part_ml[2 * p + 1] = Lsum;
        }
    }
}

// one block of HD threads per (b, kv head, q head of the group)
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml, T* __restrict__ out,
                                      int nsplit, int HD) {
    const size_t row = blockIdx.x;
    const int d = threadIdx.x;
    const float* ml = part_ml + row * nsplit * 2;
    float M = -INFINITY;
    for (int s = 0; s < nsplit; ++s)
        if (ml[2 * s + 1] > 0.f) M = fmaxf(M, ml[2 * s]);
    float Lsum = 0.f, A = 0.f;
    for (int s = 0; s < nsplit; ++s) {
        if (ml[2 * s + 1] > 0.f) {
            const float w = expf(ml[2 * s] - M);
            Lsum = fmaf(ml[2 * s + 1], w, Lsum);
            A = fmaf(part_acc[(row * nsplit + s) * HD + d], w, A);
        }
    }
    store1(out + row * HD + d, A / fmaxf(Lsum, 1e-30f));
}

template <typename T, int HD, int G>
cudaError_t launch_split(const void* q, const void* k, const void* v, const int* pos,
                         float* part_acc, float* part_ml, int B, int KV, int g, int S,
                         int chunk, int nsplit, int window, float scale, cudaStream_t stream) {
    const dim3 grid(nsplit, KV * (g / G), B);
    decode_split_kernel<T, HD, G><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos,
        part_acc, part_ml, KV, g, S, chunk, nsplit, window, scale);
    return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_g(const void* q, const void* k, const void* v, const int* pos,
                     float* part_acc, float* part_ml, int B, int KV, int g, int S, int chunk,
                     int nsplit, int window, float scale, cudaStream_t stream) {
    if (g % 8 == 0)
        return launch_split<T, HD, 8>(q, k, v, pos, part_acc, part_ml, B, KV, g, S, chunk, nsplit, window, scale, stream);
    if (g % 4 == 0)
        return launch_split<T, HD, 4>(q, k, v, pos, part_acc, part_ml, B, KV, g, S, chunk, nsplit, window, scale, stream);
    if (g % 2 == 0)
        return launch_split<T, HD, 2>(q, k, v, pos, part_acc, part_ml, B, KV, g, S, chunk, nsplit, window, scale, stream);
    return launch_split<T, HD, 1>(q, k, v, pos, part_acc, part_ml, B, KV, g, S, chunk, nsplit, window, scale, stream);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* pos, void* out,
                   float* part_acc, float* part_ml, int B, int KV, int g, int S, int hd,
                   int chunk, int nsplit, int window, float scale, cudaStream_t stream) {
    cudaError_t err;
    switch (hd) {
        case 32: err = launch_g<T, 32>(q, k, v, pos, part_acc, part_ml, B, KV, g, S, chunk, nsplit, window, scale, stream); break;
        case 64: err = launch_g<T, 64>(q, k, v, pos, part_acc, part_ml, B, KV, g, S, chunk, nsplit, window, scale, stream); break;
        case 128: err = launch_g<T, 128>(q, k, v, pos, part_acc, part_ml, B, KV, g, S, chunk, nsplit, window, scale, stream); break;
        default: return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
    decode_combine_kernel<T><<<B * KV * g, hd, 0, stream>>>(part_acc, part_ml,
                                                           static_cast<T*>(out), nsplit, hd);
    return cudaGetLastError();
}

}  // namespace

// q (B,KV,g,hd), k/v (B,KV,S,hd), out (B,KV,g,hd), all contiguous and 16-byte
// aligned; pos one int32 on the device. part_acc (B*KV*g*nsplit*hd) and part_ml
// (B*KV*g*nsplit*2) are float32 scratch; the split s covers keys
// [s*chunk, (s+1)*chunk), and nsplit*chunk >= S. dtype: 0 = float32, 2 = bfloat16;
// hd in {32, 64, 128}. Returns the cudaError_t of the launches (0 = cudaSuccess);
// cudaErrorInvalidValue for an unsupported dtype, hd or geometry.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* pos, void* out, void* part_acc,
                                       void* part_ml, int B, int KV, int g, int S, int hd,
                                       int dtype, int window, float scale, int chunk,
                                       int nsplit, void* stream) {
    if (B <= 0 || KV <= 0 || g <= 0) return cudaSuccess;
    if (S <= 0 || chunk <= 0 || nsplit <= 0 ||
        static_cast<long long>(chunk) * nsplit < S)
        return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* p = static_cast<const int*>(pos);
    float* pa = static_cast<float*>(part_acc);
    float* pm = static_cast<float*>(part_ml);
    switch (dtype) {
        case 0: return static_cast<int>(
            launch<float>(q, k, v, p, out, pa, pm, B, KV, g, S, hd, chunk, nsplit, window, scale, st));
        case 2: return static_cast<int>(
            launch<__nv_bfloat16>(q, k, v, p, out, pa, pm, B, KV, g, S, hd, chunk, nsplit, window, scale, st));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
