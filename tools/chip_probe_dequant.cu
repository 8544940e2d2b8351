// Diagnostics for tools/chip_probe.py, built beside the port's kernels: the
// production dequant kernel (included) at another group size, and a copy of its
// loop that stamps each block with %globaltimer. Not used by the port.
#include "../src/repro_torch/kernels/csrc/dequant_u8.cu"

namespace {

__device__ __forceinline__ unsigned long long now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// dequant_u8_kernel's loop with per-block stamps (thread 0): start, scales
// loaded, first group stored, end
template <typename T, int E, int U>
__global__ void __launch_bounds__(kThreads)
stamped_kernel(const uint8_t* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, typename T::raw* __restrict__ out, int64_t C,
               int64_t groups, int64_t stride, unsigned long long* __restrict__ stamps) {
    unsigned long long t[4] = {now(), 0, 0, 0};
    const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (tid < stride) {
        float s[E], b[E];
        int64_t c = (tid * E) % C;
#pragma unroll
        for (int j = 0; j < E; ++j) {
            s[j] = __ldg(scale + c);
            b[j] = __ldg(bias + c);
            if (++c == C) c = 0;
        }
        t[1] = now();
        for (int64_t g0 = tid; g0 < groups; g0 += U * stride) {
            Codes<E> in[U];
#pragma unroll
            for (int u = 0; u < U; ++u)
                if (g0 + u * stride < groups) in[u].load(x + (g0 + u * stride) * E);
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int64_t g = g0 + u * stride;
                if (g < groups) {
                    float v[E];
#pragma unroll
                    for (int j = 0; j < E; ++j) v[j] = affine(in[u].code(j), s[j], b[j]);
                    put<T, E>(out + g * E, v);
                }
                if (t[2] == 0) t[2] = now();
            }
        }
    }
    t[3] = now();
    if (threadIdx.x == 0)
        for (int k = 0; k < 4; ++k) stamps[4 * blockIdx.x + k] = t[k];
}

}  // namespace

// f32 (out_kind 0) or bf16 (2) output. mode 0: the production kernel with groups of
// 16 codes (one uint4 load, out_bytes 16-byte stores a thread); mode 1: the
// production group size with stamps written to `stamps` (4 a block). n must be a
// multiple of the group; blocks and stride as dequant_u8.py:geometry plans them.
extern "C" int chip_probe_dequant(const void* x, const void* scale, const void* bias, void* out,
                                  int64_t n, int64_t C, int out_kind, int mode, int64_t blocks,
                                  int64_t stride, void* stamps, void* stream) {
    const auto* xq = static_cast<const uint8_t*>(x);
    const auto* s = static_cast<const float*>(scale);
    const auto* b = static_cast<const float*>(bias);
    auto* st = static_cast<unsigned long long*>(stamps);
    cudaStream_t cs = static_cast<cudaStream_t>(stream);
    const unsigned grid = static_cast<unsigned>(blocks);
    if (out_kind == 0 && mode == 0)
        dequant_u8_kernel<F32, 16, 1><<<grid, kThreads, 0, cs>>>(
            xq, s, b, static_cast<uint32_t*>(out), n, C, n / 16, stride);
    else if (out_kind == 2 && mode == 0)
        dequant_u8_kernel<BF16, 16, 1><<<grid, kThreads, 0, cs>>>(
            xq, s, b, static_cast<uint16_t*>(out), n, C, n / 16, stride);
    else if (out_kind == 0 && mode == 1)
        stamped_kernel<F32, 4, 8><<<grid, kThreads, 0, cs>>>(
            xq, s, b, static_cast<uint32_t*>(out), C, n / 4, stride, st);
    else
        return cudaErrorInvalidValue;
    return static_cast<int>(cudaGetLastError());
}
