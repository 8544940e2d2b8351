// GQA decode attention (one query token per sequence against the KV cache), forward,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:decode_attention_fwd
// (Pallas; grid (B, KV, S blocks) with the S-block axis sequential, the online-
// softmax state of the whole q-head group in VMEM scratch, and pos scalar-
// prefetched). Semantics are the TPU kernel's: f32 inside, positions <= pos live,
// window > 0 adds kpos > pos - window, output acc / max(l, 1e-30) rounded once to
// q's type.
//
// What bounds it on this card: bytes. Every live K and V row is read once and used
// for g dot products and g axpys, about 2g operations per byte, far below the
// card's 295, so the least time is the live cache bytes over 3.35 TB/s and tensor
// cores would not help. The TPU walks S in order on one core; here that would leave
// one block per (b, kv head), 64 blocks on 132 SMs at the serving path's B = 8,
// KV = 8. The design, one launch and no global scratch:
//   * the S splits of one (b, kv head, chunk of G query heads) form one thread block
//     cluster of 1, 2, 4 or 8 CTAs along grid x; decode_attention.py:geometry plans
//     one CTA an SM (2 CTAs of 288 keys at the serving shape: clusters of 4 and 8
//     CTAs do not all fit at once, measured, and the late ones double the time).
//     Split bounds are fixed by S, not by pos. A CTA serves G query heads (the
//     largest of 8, 4, 2, 1 dividing g), so each K/V row is read once per G heads;
//   * K and V reach shared memory through a ring of up to 8 stages of 64 rows (32 for
//     f32 at hd 256, where a 64-row stage of K and V is 128 KB and two would not fit) under
//     mbarriers, as deep as the CTAs an SM holds allow (up to 192 KB in flight): one
//     producer thread issues 1-D bulk copies (cp.async.bulk ... mbarrier::
//     complete_tx::bytes) of the live rows only. A (b, kv head) slab of the cache is
//     contiguous, so a tile is one byte range of K and one of V; the last tile's row
//     count comes from pos and the window, so no row past pos (or before the window)
//     is ever copied or read;
//   * eight consumer warps take 8 keys of each tile (4 for f32 at hd 256). A "team" of
//     hd/8 lanes owns a key (a whole warp at hd 256): 16-byte shared-memory reads of
//     K, the f32 dot products with the G query rows (held in registers) reduced by
//     shuffles inside the team. Softmax goes per tile, not per key: one max per tile
//     and head across the warp, one exp2 for the rescale, one exp2 per score, with
//     scale * log2(e) folded into the scores; P·V accumulates in f32 registers. A warp releases the stage on its empty barrier;
//   * the splits fold through distributed shared memory, pushed rather than pulled:
//     each consumer warp writes its (m, l) to every CTA of the cluster and each of its
//     acc outputs to the CTA that folds that output (CTA r takes outputs [r·share,
//     (r+1)·share) of the G·hd, share = G·hd / cluster), then one cluster barrier
//     (arrive.release / wait.acquire), and each CTA folds its share from its own
//     shared memory over the 8·cluster partials in a fixed order, so the result is
//     deterministic. No remote access follows the barrier, so a CTA may exit at once;
//     an earlier arrive (relaxed), waited on before the first remote write, makes sure
//     every CTA of the cluster is running. A warp that saw no live key has l = 0 and
//     is skipped;
//   * pos is read from a device int32, never from the host, and the launch
//     allocates nothing, so a decode step issues no host sync.
// Measured on an H100 (PERF.md): the cold cache streams at about 2.5 TB/s here, and
// at the serving shape the pos read, the first tile's round trip and the fold add
// some 5 µs to the 7.6 µs of streaming.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;                    // consumer warps
constexpr int kThreads = (kWarps + 1) * 32;  // + one producer warp
constexpr int kMaxStages = 8;
constexpr int kMaxCluster = 8;
constexpr float kNeg = -1e30f;  // "no key yet": finite, so kNeg - kNeg is 0, not NaN
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void load8(const float* p, float* v) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
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

// `bytes` contiguous bytes from global memory into this CTA's shared memory;
// completion is counted in bytes on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// the cluster barrier, split: arrive (release: this thread's earlier writes, remote
// ones included, are visible to every thread that has waited) and wait (acquire)
__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// live key range [lo, hi] of the cache for this pos (hi < lo: none)
__device__ __forceinline__ void live_range(int pos, int S, int window, int* lo, int* hi) {
    *lo = (window > 0 && pos - window + 1 > 0) ? pos - window + 1 : 0;
    *hi = pos < S - 1 ? pos : S - 1;
}

// Shared memory: K ring | V ring | what the cluster's warps send this CTA: their
// (m, l) for every head [4·kMaxCluster][G] each, and their acc for this CTA's share of
// the G·hd outputs [4·cluster][share] | barriers
template <typename T, int HD, int G>
struct Layout {
    // K/V rows per ring stage (8 a consumer warp); 32 where a row of T is 1 KB (f32 at
    // hd 256), so that a ring of two stages and the receive area fit in shared memory
    static constexpr int kTile = HD * sizeof(T) >= 1024 ? 32 : 64;
    static constexpr int kStageBytes = kTile * HD * static_cast<int>(sizeof(T));
    static constexpr int kSlots = kWarps * kMaxCluster;
    static constexpr int kRecvFloats = 2 * kSlots * G + kWarps * (G * HD + kMaxCluster);
    static __host__ __device__ int recv_off(int stages) { return 2 * stages * kStageBytes; }
    static __host__ __device__ int bar_off(int stages) { return recv_off(stages) + 4 * kRecvFloats; }
    static __host__ __device__ int bytes(int stages) { return bar_off(stages) + 16 * kMaxStages; }
};

// CTAs an SM should be able to hold (the geometry plans for one; at hd 256 a ring of
// two stages takes most of an SM's shared memory)
template <int HD, int G>
constexpr int min_blocks() { return G >= 4 || HD >= 256 ? 1 : 2; }

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads, min_blocks<HD, G>())
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ pos_ptr,
                        T* __restrict__ out, int KV, int g, int S, int chunk, int stages,
                        int window, float scale_log2) {
    using Lay = Layout<T, HD, G>;
    constexpr int kTile = Lay::kTile;
    constexpr int kLanes = HD / 8;           // lanes of a team: one key at a time
    constexpr int kTeams = 32 / kLanes;      // keys a warp reads at once
    constexpr int kKeys = kTile / kWarps;    // keys of a tile per warp
    constexpr int kPasses = kKeys / kTeams;
    static_assert(kPasses >= 1 && kKeys % kTeams == 0, "tile split");

    extern __shared__ __align__(128) unsigned char smem[];
    T* sK = reinterpret_cast<T*>(smem);
    T* sV = reinterpret_cast<T*>(smem + stages * Lay::kStageBytes);
    float* r_m = reinterpret_cast<float*>(smem + Lay::recv_off(stages));  // [slot][G]
    float* r_l = r_m + Lay::kSlots * G;                                    // [slot][G]
    float* r_acc = r_l + Lay::kSlots * G;                                  // [slot][share]
    const uint32_t bars = smem_addr(smem + Lay::bar_off(stages));
    auto full = [&](int s) { return bars + 8 * s; };
    auto empty = [&](int s) { return bars + 8 * (kMaxStages + s); };

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int csize = static_cast<int>(cluster.num_blocks());
    const int share = (G * HD + csize - 1) / csize;  // outputs each CTA folds
    // every CTA of the cluster has started before any writes another's shared memory:
    // arrive now, wait just before the first remote write
    cluster_arrive_relaxed();
    const int chunks = g / G;
    const int kvh = blockIdx.y / chunks;
    const int head0 = (blockIdx.y % chunks) * G;
    const int b = blockIdx.z;
    const size_t bk = static_cast<size_t>(b) * KV + kvh;

    int lo, hi;
    live_range(__ldg(pos_ptr), S, window, &lo, &hi);
    const int s0 = max(lo, rank * chunk);
    const int s1 = min(hi + 1, (rank + 1) * chunk);  // this CTA's live keys: [s0, s1)
    const int n_tiles = s1 > s0 ? (s1 - s0 + kTile - 1) / kTile : 0;

    if (threadIdx.x == 0) {
        for (int s = 0; s < stages; ++s) {
            bar_init(full(s), 1);
            bar_init(empty(s), kWarps);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    float m[G], l[G], acc[G][8];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
        m[gi] = kNeg;
        l[gi] = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[gi][e] = 0.f;
    }

    if (warp == kWarps) {
        // producer: one thread issues every copy; the warp then joins the folds
        if (lane == 0) {
            const T* kb = k + bk * S * HD;
            const T* vb = v + bk * S * HD;
            for (int i = 0; i < n_tiles; ++i) {
                const int st = i % stages;
                if (i >= stages) bar_wait(empty(st), (i / stages - 1) & 1);
                const int t0 = s0 + i * kTile;
                const int bytes = min(kTile, s1 - t0) * HD * static_cast<int>(sizeof(T));
                bar_expect_tx(full(st), 2 * bytes);
                bulk_load(smem_addr(sK + st * kTile * HD), kb + static_cast<size_t>(t0) * HD,
                          bytes, full(st));
                bulk_load(smem_addr(sV + st * kTile * HD), vb + static_cast<size_t>(t0) * HD,
                          bytes, full(st));
            }
        }
        __syncwarp();
    } else {
        const int team = lane / kLanes;
        const int tl = lane % kLanes;  // this lane's 8 columns: tl*8 .. tl*8+7
        float qr[G][8];
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
            load8(q + (bk * g + head0 + gi) * HD + tl * 8, qr[gi]);
#pragma unroll
            for (int e = 0; e < 8; ++e) qr[gi][e] *= scale_log2;
        }
        for (int i = 0; i < n_tiles; ++i) {
            const int st = i % stages;
            const int rows = min(kTile, s1 - (s0 + i * kTile));
            bar_wait(full(st), (i / stages) & 1);
            const T* kt = sK + st * kTile * HD + tl * 8;
            const T* vt = sV + st * kTile * HD + tl * 8;

            // scores (log2 units) of this warp's keys; a team's lanes agree on them
            float sc[kPasses][G];
            float mx[G];
#pragma unroll
            for (int gi = 0; gi < G; ++gi) mx[gi] = kNeg;
#pragma unroll
            for (int u = 0; u < kPasses; ++u) {
                const int key = warp * kKeys + u * kTeams + team;  // row of the tile
                float kr[8];
                load8(kt + key * HD, kr);
#pragma unroll
                for (int gi = 0; gi < G; ++gi) {
                    float s = 0.f;
#pragma unroll
                    for (int e = 0; e < 8; ++e) s = fmaf(qr[gi][e], kr[e], s);
#pragma unroll
                    for (int off = kLanes / 2; off > 0; off >>= 1)
                        s += __shfl_xor_sync(0xffffffffu, s, off);
                    sc[u][gi] = key < rows ? s : kNeg;  // rows past the tile's end: stale
                    mx[gi] = fmaxf(mx[gi], sc[u][gi]);
                }
            }
#pragma unroll
            for (int gi = 0; gi < G; ++gi) {
#pragma unroll
                for (int off = kLanes; off < 32; off <<= 1)
                    mx[gi] = fmaxf(mx[gi], __shfl_xor_sync(0xffffffffu, mx[gi], off));
                const float m_new = fmaxf(m[gi], mx[gi]);
                const float alpha = exp2_approx(m[gi] - m_new);  // 0 after no key, 1 if no new max
                m[gi] = m_new;
                l[gi] *= alpha;
#pragma unroll
                for (int e = 0; e < 8; ++e) acc[gi][e] *= alpha;
            }
#pragma unroll
            for (int u = 0; u < kPasses; ++u) {
                const int key = warp * kKeys + u * kTeams + team;
                if (key >= rows) continue;  // never touch a stale row: it may hold anything
                float vr[8];
                load8(vt + key * HD, vr);
#pragma unroll
                for (int gi = 0; gi < G; ++gi) {
                    const float p = exp2_approx(sc[u][gi] - m[gi]);
                    l[gi] += p;
#pragma unroll
                    for (int e = 0; e < 8; ++e) acc[gi][e] = fmaf(p, vr[e], acc[gi][e]);
                }
            }
            __syncwarp();
            if (lane == 0) bar_arrive(empty(st));
        }
        // the warp's teams share m: sum their l and acc over the teams
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
#pragma unroll
            for (int off = kLanes; off < 32; off <<= 1) {
                l[gi] += __shfl_xor_sync(0xffffffffu, l[gi], off);
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    acc[gi][e] += __shfl_xor_sync(0xffffffffu, acc[gi][e], off);
            }
        }
    }
    cluster_wait();  // every CTA of the cluster runs: its shared memory may be written

    // push this warp's partial state: (m, l) to every CTA, output idx of acc to the
    // CTA that folds it (idx / share), in slot rank·kWarps + warp
    if (warp < kWarps) {
        const int slot = rank * kWarps + warp;
        if (lane < csize) {
            float* dm = cluster.map_shared_rank(r_m, lane);
            float* dl = cluster.map_shared_rank(r_l, lane);
#pragma unroll
            for (int gi = 0; gi < G; ++gi) {
                dm[slot * G + gi] = m[gi];
                dl[slot * G + gi] = l[gi];
            }
        }
        if (lane < kLanes) {
#pragma unroll
            for (int gi = 0; gi < G; ++gi) {
                const int idx = gi * HD + lane * 8;
                if (share % 8 == 0) {  // the lane's 8 outputs go to one CTA: two 16-byte stores
                    const int dst = idx / share;
                    float4* d = reinterpret_cast<float4*>(
                        cluster.map_shared_rank(r_acc, dst) + slot * share + idx - dst * share);
                    d[0] = make_float4(acc[gi][0], acc[gi][1], acc[gi][2], acc[gi][3]);
                    d[1] = make_float4(acc[gi][4], acc[gi][5], acc[gi][6], acc[gi][7]);
                } else {
#pragma unroll
                    for (int e = 0; e < 8; ++e) {
                        const int dst = (idx + e) / share;
                        cluster.map_shared_rank(r_acc, dst)[slot * share + idx + e - dst * share] =
                            acc[gi][e];
                    }
                }
            }
        }
    }
    cluster_arrive();  // release: this CTA's pushes are visible once all have arrived
    cluster_wait();    // acquire: every partial of this CTA's share has landed

    // fold this CTA's share over the cluster's warps, slots in order: deterministic.
    // No remote access follows, so a CTA may exit as soon as it is done.
    const int slots = csize * kWarps;
    for (int j = threadIdx.x; j < share && rank * share + j < G * HD; j += kThreads) {
        const int idx = rank * share + j;
        const int gi = idx / HD;
        float M = kNeg;
#pragma unroll 8
        for (int q = 0; q < slots; ++q)
            if (r_l[q * G + gi] > 0.f) M = fmaxf(M, r_m[q * G + gi]);
        float Lsum = 0.f, A = 0.f;
#pragma unroll 8
        for (int q = 0; q < slots; ++q) {
            if (r_l[q * G + gi] > 0.f) {
                const float wt = exp2_approx(r_m[q * G + gi] - M);
                Lsum = fmaf(r_l[q * G + gi], wt, Lsum);
                A = fmaf(r_acc[q * share + j], wt, A);
            }
        }
        store1(out + (bk * g + head0) * HD + idx, A / fmaxf(Lsum, 1e-30f));
    }
}

// SMs of the current device (asked once a device)
int sm_count() {
    static int counts[64] = {0};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
    if (counts[dev] == 0) {
        int n = 0;
        if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
            return 132;
        counts[dev] = n;
    }
    return counts[dev];
}

template <typename T, int HD, int G>
cudaError_t launch_g(const void* q, const void* k, const void* v, const int* pos, void* out,
                     int B, int KV, int g, int S, int window, float scale, int cluster,
                     int chunk, cudaStream_t stream) {
    using Lay = Layout<T, HD, G>;
    // the deepest ring that lets this launch's CTAs share the SMs in one wave
    const int ctas = cluster * KV * (g / G) * B;
    const int per_sm = (ctas + sm_count() - 1) / sm_count();
    const int room = 220 * 1024 / max(per_sm, 1) - Lay::bytes(0) - 1024;
    const int stages = max(1, min((chunk + Lay::kTile - 1) / Lay::kTile,
                                  max(2, min(kMaxStages, room / (2 * Lay::kStageBytes)))));
    const int bytes = Lay::bytes(stages);
    auto kernel = decode_attention_kernel<T, HD, G>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           bytes);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, KV * (g / G), B);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
                             static_cast<const T*>(v), pos, static_cast<T*>(out), KV, g, S,
                             chunk, stages, window, scale * kLog2e);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, const int* pos, void* out,
                      int B, int KV, int g, int S, int window, float scale, int cluster,
                      int chunk, cudaStream_t stream) {
    if (g % 8 == 0)
        return launch_g<T, HD, 8>(q, k, v, pos, out, B, KV, g, S, window, scale, cluster, chunk, stream);
    if (g % 4 == 0)
        return launch_g<T, HD, 4>(q, k, v, pos, out, B, KV, g, S, window, scale, cluster, chunk, stream);
    if (g % 2 == 0)
        return launch_g<T, HD, 2>(q, k, v, pos, out, B, KV, g, S, window, scale, cluster, chunk, stream);
    return launch_g<T, HD, 1>(q, k, v, pos, out, B, KV, g, S, window, scale, cluster, chunk, stream);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* pos, void* out,
                   int B, int KV, int g, int S, int hd, int window, float scale, int cluster,
                   int chunk, cudaStream_t stream) {
    switch (hd) {
        case 32: return launch_hd<T, 32>(q, k, v, pos, out, B, KV, g, S, window, scale, cluster, chunk, stream);
        case 64: return launch_hd<T, 64>(q, k, v, pos, out, B, KV, g, S, window, scale, cluster, chunk, stream);
        case 128: return launch_hd<T, 128>(q, k, v, pos, out, B, KV, g, S, window, scale, cluster, chunk, stream);
        case 256: return launch_hd<T, 256>(q, k, v, pos, out, B, KV, g, S, window, scale, cluster, chunk, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// q (B,KV,g,hd), k/v (B,KV,S,hd), out (B,KV,g,hd), all contiguous and 16-byte
// aligned; pos one int32 on the device. The S keys are split over `cluster` CTAs
// (1, 2, 4 or 8) of one thread block cluster, CTA r taking keys [r*chunk,
// (r+1)*chunk); cluster*chunk >= S. dtype: 0 = float32, 2 = bfloat16; hd in
// {32, 64, 128, 256}. One kernel launch. Returns its cudaError_t (0 = cudaSuccess);
// cudaErrorInvalidValue for an unsupported dtype, hd or geometry.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* pos, void* out, int B, int KV, int g,
                                       int S, int hd, int dtype, int window, float scale,
                                       int cluster, int chunk, void* stream) {
    if (B <= 0 || KV <= 0 || g <= 0) return cudaSuccess;
    if (S <= 0 || chunk <= 0 || cluster < 1 || cluster > kMaxCluster ||
        (cluster & (cluster - 1)) != 0 || static_cast<long long>(chunk) * cluster < S)
        return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* p = static_cast<const int*>(pos);
    switch (dtype) {
        case 0: return static_cast<int>(
            launch<float>(q, k, v, p, out, B, KV, g, S, hd, window, scale, cluster, chunk, st));
        case 2: return static_cast<int>(
            launch<__nv_bfloat16>(q, k, v, p, out, B, KV, g, S, hd, window, scale, cluster, chunk, st));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
