// A CPU emulation of the CUDA subset the port's SIMT kernels use, for
// tests/test_torch_ssd.py: each block's threads are std::threads, blocks run one
// after another, __syncthreads is a std::barrier over the block, __shfl_xor_sync an
// exchange within the warp, and dynamic shared memory one global array. A source is
// compiled against it with g++ -std=c++20 -pthread after emu.py rewrites its launches.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>
using std::min; using std::max;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __shared__
struct dim3 { unsigned x = 1, y = 1, z = 1; dim3() {} dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <typename F> inline cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline std::barrier<>* g_block_bar = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> g_warp_bar;
inline float g_xchg[1024];
inline void __syncthreads() { g_block_bar->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int off) {
    const int t = threadIdx.x, w = t / 32;
    g_warp_bar[w]->arrive_and_wait();
    g_xchg[t] = v;
    g_warp_bar[w]->arrive_and_wait();
    const float o = g_xchg[(t & ~31) | ((t % 32) ^ off)];
    g_warp_bar[w]->arrive_and_wait();
    return o;
}
struct __nv_bfloat16 { uint16_t bits; };
inline float __bfloat162float(__nv_bfloat16 v) { uint32_t u = uint32_t(v.bits) << 16; float f; std::memcpy(&f, &u, 4); return f; }
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
    uint32_t u; std::memcpy(&u, &f, 4);
    u += 0x7FFF + ((u >> 16) & 1);
    return __nv_bfloat16{uint16_t(u >> 16)};
}
inline float sm[65536];
template <typename K, typename... A>
void emu_launch(K kernel, dim3 grid, dim3 block, int, cudaStream_t, A... args) {
    gridDim = grid; blockDim = block;
    const int n = block.x;
    for (unsigned z = 0; z < grid.z; ++z)
        for (unsigned y = 0; y < grid.y; ++y)
            for (unsigned x = 0; x < grid.x; ++x) {
                std::barrier<> bar(n);
                g_block_bar = &bar;
                g_warp_bar.clear();
                for (int w = 0; w < (n + 31) / 32; ++w) g_warp_bar.emplace_back(new std::barrier<>(32));
                std::vector<std::thread> ts;
                for (int t = 0; t < n; ++t)
                    ts.emplace_back([=] { threadIdx = dim3(t); blockIdx = dim3(x, y, z); kernel(args...); });
                for (auto& th : ts) th.join();
            }
}
