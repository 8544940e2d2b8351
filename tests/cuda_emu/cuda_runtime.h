// A CPU emulation of the CUDA subset the port's scan-backward kernels use, for
// tests/test_torch_ssd.py. A block's threads are fibers (ucontext) that one OS thread
// runs in turn, each until it reaches a barrier: __syncthreads waits for the block, a
// warp-wide operation (a shuffle, and the tensor-core kernels' mma.sync, ldmatrix) for
// the warp. Blocks run one after another; dynamic shared memory is one global array.
// The warp-wide instructions are emulated in namespace emu; CUDA_EMU_MMA tells a source
// they are there. A source is compiled against it with g++ -std=c++20 after emu.py
// rewrites its launches.
#pragma once
#include <ucontext.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>
using std::min; using std::max;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __shared__
#define CUDA_EMU_MMA 1
struct dim3 { unsigned x = 1, y = 1, z = 1; dim3() {} dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float2 make_float2(float a, float b) { return float2{a, b}; }
inline dim3 threadIdx, blockIdx;  // the running fiber's
inline dim3 blockDim, gridDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <typename F> inline cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// ---- the fibers of the running block
constexpr int kEmuMaxThreads = 1024;
constexpr size_t kEmuStack = 256 * 1024;
struct EmuFiber {
    ucontext_t ctx;
    char* stack = nullptr;
    int wait = -1;           // the barrier it waits at: -1 none, 0 the block's, 1 + w warp w's
    unsigned target = 0;     // that barrier's generation that releases it
    bool done = false;
};
inline EmuFiber g_fibers[kEmuMaxThreads];
inline ucontext_t g_sched;
inline int g_running = 0;
inline unsigned g_arrived[1 + kEmuMaxThreads / 32], g_generation[1 + kEmuMaxThreads / 32];
inline std::function<void()> g_body;

// wait at barrier `bar` (0: the block, 1 + w: warp w) of `count` threads
inline void emu_barrier(int bar, unsigned count) {
    EmuFiber& f = g_fibers[g_running];
    f.wait = bar;
    f.target = g_generation[bar] + 1;
    if (++g_arrived[bar] == count) {
        g_arrived[bar] = 0;
        ++g_generation[bar];
    }
    swapcontext(&f.ctx, &g_sched);
}
inline void __syncthreads() { emu_barrier(0, blockDim.x); }
inline void emu_warp_barrier() { emu_barrier(1 + threadIdx.x / 32, 32); }

inline void emu_fiber_entry() {
    g_body();
    g_fibers[g_running].done = true;
}

// Warp-wide operations exchange through slots of two parities: a lane writes its slot of
// this operation's parity, waits at the warp's barrier, then reads the others'. The next
// operation uses the other parity, and the one after that this parity again only past the
// next operation's barrier, which every lane reaches after its reads: one barrier an
// operation. The lanes of a warp run the same sequence of them, so their parities agree.
inline unsigned g_parity[kEmuMaxThreads];
inline int emu_exchange_parity() { return g_parity[threadIdx.x]++ & 1; }
inline float g_xchg[2][kEmuMaxThreads];
// lane `src(lane)`'s v, for every lane of the warp
template <typename F>
inline float emu_shfl(float v, F src) {
    const int t = threadIdx.x, p = emu_exchange_parity();
    g_xchg[p][t] = v;
    emu_warp_barrier();
    const int s = src(t % 32);
    return s >= 0 && s < 32 ? g_xchg[p][(t & ~31) | s] : v;
}
inline float __shfl_xor_sync(unsigned, float v, int off) { return emu_shfl(v, [&](int l) { return l ^ off; }); }
inline float __shfl_up_sync(unsigned, float v, int off) { return emu_shfl(v, [&](int l) { return l - off; }); }
inline float __shfl_down_sync(unsigned, float v, int off) { return emu_shfl(v, [&](int l) { return l + off; }); }
inline float __shfl_sync(unsigned, float v, int src) { return emu_shfl(v, [&](int) { return src; }); }
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
struct __nv_bfloat16 { uint16_t bits; };
inline float __bfloat162float(__nv_bfloat16 v) { uint32_t u = uint32_t(v.bits) << 16; float f; std::memcpy(&f, &u, 4); return f; }
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
    uint32_t u; std::memcpy(&u, &f, 4);
    u += 0x7FFF + ((u >> 16) & 1);
    return __nv_bfloat16{uint16_t(u >> 16)};
}
alignas(128) inline float sm[65536];

namespace emu {
inline const void* g_addr[2][kEmuMaxThreads];
inline uint32_t g_regs[2][kEmuMaxThreads][6];

// ldmatrix.sync.aligned.m8n8.x{count}[.trans].shared.b16: lane 8m + r gives the row
// address of row r of matrix m; register m of lane l holds (row l/4, columns 2(l%4),
// 2(l%4)+1) of matrix m, or of its transpose
inline void ldsm(uint32_t* r, int count, const void* p, bool trans) {
    const int t = threadIdx.x, w = t & ~31, l = t % 32, q = emu_exchange_parity();
    const void* const* g_addr = emu::g_addr[q];
    emu::g_addr[q][t] = p;
    emu_warp_barrier();
    for (int m = 0; m < count; ++m) {
        uint16_t lo, hi;
        if (!trans) {
            const uint16_t* row = static_cast<const uint16_t*>(g_addr[w + 8 * m + l / 4]);
            lo = row[2 * (l % 4)];
            hi = row[2 * (l % 4) + 1];
        } else {
            lo = static_cast<const uint16_t*>(g_addr[w + 8 * m + 2 * (l % 4)])[l / 4];
            hi = static_cast<const uint16_t*>(g_addr[w + 8 * m + 2 * (l % 4) + 1])[l / 4];
        }
        r[m] = uint32_t(lo) | uint32_t(hi) << 16;
    }
}
inline void ldsm_x4(uint32_t (&r)[4], const void* p) { ldsm(r, 4, p, false); }
inline void ldsm_x4_t(uint32_t (&r)[4], const void* p) { ldsm(r, 4, p, true); }
inline void ldsm_x2_t(uint32_t (&r)[2], const void* p) { ldsm(r, 2, p, true); }
inline void ldsm_x1_t(uint32_t& r, const void* p) { ldsm(&r, 1, p, true); }

inline float bf16_at(uint32_t pair, int half) { return __uint_as_float(half ? pair & 0xFFFF0000u : pair << 16); }

// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: products exact, summed in
// double, added to the accumulator in f32
inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    const int t = threadIdx.x, w = t & ~31, l = t % 32, q = emu_exchange_parity();
    uint32_t (*g_regs)[6] = emu::g_regs[q];
    for (int i = 0; i < 4; ++i) g_regs[t][i] = a[i];
    g_regs[t][4] = b0;
    g_regs[t][5] = b1;
    emu_warp_barrier();
    for (int e = 0; e < 4; ++e) {
        const int row = l / 4 + 8 * (e / 2), col = 2 * (l % 4) + e % 2;
        double s = 0;
        for (int k = 0; k < 16; ++k) {
            const float av = bf16_at(g_regs[w + (row % 8) * 4 + (k % 8) / 2][row / 8 + 2 * (k / 8)], k % 2);
            const float bv = bf16_at(g_regs[w + col * 4 + (k % 8) / 2][4 + k / 8], k % 2);
            s += double(av) * double(bv);
        }
        d[e] = float(double(d[e]) + s);
    }
}

// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32: the operands' low 13 bits are
// not read
inline void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                     uint32_t b0, uint32_t b1) {
    const int t = threadIdx.x, w = t & ~31, l = t % 32, q = emu_exchange_parity();
    uint32_t (*g_regs)[6] = emu::g_regs[q];
    g_regs[t][0] = a0; g_regs[t][1] = a1; g_regs[t][2] = a2; g_regs[t][3] = a3;
    g_regs[t][4] = b0; g_regs[t][5] = b1;
    emu_warp_barrier();
    for (int e = 0; e < 4; ++e) {
        const int row = l / 4 + 8 * (e / 2), col = 2 * (l % 4) + e % 2;
        double s = 0;
        for (int k = 0; k < 8; ++k) {
            const float av = __uint_as_float(g_regs[w + (row % 8) * 4 + k % 4][row / 8 + 2 * (k / 4)] & 0xFFFFE000u);
            const float bv = __uint_as_float(g_regs[w + col * 4 + k % 4][4 + k / 4] & 0xFFFFE000u);
            s += double(av) * double(bv);
        }
        d[e] = float(double(d[e]) + s);
    }
}

// cvt.rn.tf32.f32: round to nearest even at 10 mantissa bits
inline uint32_t tf32(float v) {
    const uint32_t b = __float_as_uint(v);
    return (b + 0xFFFu + ((b >> 13) & 1u)) & 0xFFFFE000u;
}

// cp.async: a plain copy (the emulator's copies land at once); commit and wait do nothing
inline void cp16(void* dst, const void* src) { std::memcpy(dst, src, 16); }
inline void cp_commit() {}
template <int PENDING> inline void cp_wait() {}
}  // namespace emu

template <typename K, typename... A>
void emu_launch(K kernel, dim3 grid, dim3 block, int, cudaStream_t, A... args) {
    gridDim = grid;
    blockDim = block;
    const int n = block.x;
    for (int t = 0; t < n; ++t)
        if (g_fibers[t].stack == nullptr) g_fibers[t].stack = static_cast<char*>(std::malloc(kEmuStack));
    g_body = [=] { kernel(args...); };
    for (unsigned z = 0; z < grid.z; ++z)
        for (unsigned y = 0; y < grid.y; ++y)
            for (unsigned x = 0; x < grid.x; ++x) {
                blockIdx = dim3(x, y, z);
                std::memset(g_arrived, 0, sizeof(g_arrived));
                std::memset(g_generation, 0, sizeof(g_generation));
                std::memset(g_parity, 0, sizeof(g_parity));
                for (int t = 0; t < n; ++t) {
                    EmuFiber& f = g_fibers[t];
                    f.wait = -1;
                    f.done = false;
                    getcontext(&f.ctx);
                    f.ctx.uc_stack.ss_sp = f.stack;
                    f.ctx.uc_stack.ss_size = kEmuStack;
                    f.ctx.uc_link = &g_sched;
                    makecontext(&f.ctx, emu_fiber_entry, 0);
                }
                // each fiber in turn, until every one has returned; one waiting at a
                // barrier runs again once the barrier's generation has moved past it
                for (int left = n; left > 0;) {
                    bool moved = false;
                    for (int t = 0; t < n; ++t) {
                        EmuFiber& f = g_fibers[t];
                        if (f.done || (f.wait >= 0 && g_generation[f.wait] < f.target)) continue;
                        f.wait = -1;
                        g_running = t;
                        threadIdx = dim3(t);
                        swapcontext(&g_sched, &f.ctx);
                        moved = true;
                        if (f.done) --left;
                    }
                    if (!moved) {
                        std::fprintf(stderr, "emulator: every thread of a block waits at a barrier\n");
                        std::abort();
                    }
                }
            }
}
