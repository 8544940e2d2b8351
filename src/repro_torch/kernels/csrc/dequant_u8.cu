// u8 -> float dequantize for Hopper (sm_90a): out[i] = float(q[i]) * scale[c] + bias[c],
// c = i % C, rounded to the output type.
//
// Replaces the TPU kernel src/repro/kernels/dequant_u8.py:dequant_u8_fwd (Pallas,
// (block_rows, C) tiles in VMEM). On this card the work is bound by bytes: one byte
// read and 2-8 bytes written per element, no reuse, far below the card's operation
// rate, so the least time is (n + n * out_bytes) / 3.35 TB/s. The design:
//   * the contiguous input is a flat array of n codes cut into groups of E codes,
//     E = 16 / out_bytes (4 for f32, 8 for f16 and bf16, 2 for f64): a group's
//     outputs are one 16-byte store, and a warp's 32 stores are 512 contiguous bytes
//     (the outputs are 2-8 times the inputs' bytes, so the stores set the pace). A
//     group's codes are one 2-8 byte load, 32 contiguous groups a warp instruction;
//   * every thread takes the groups g = t, t + stride, t + 2·stride, ..., with the
//     stride a multiple of the channels' period in groups, C / gcd(C, E). So the
//     channels of a thread's E codes are the same in every group it takes: it loads
//     its E scales and E biases once, before the loop, and keeps them in registers.
//     Nothing in the loop reads scale or bias, and nothing divides;
//   * a thread issues the loads of U = 32 / E groups (32 bytes) before it converts
//     any, so a wave of 1,024 threads an SM keeps 32 KB of reads in flight;
//   * the grid is sized to the work (U groups a thread, at least two blocks an SM
//     while the work lasts, at most four), and to the period: a large odd C (one
//     period is C groups) gets a thread for each channel phase. The wrapper plans it
//     (dequant_u8.py:geometry), so the CPU tests can check the mapping;
//   * a misaligned pointer takes the same loop with groups of one code (E = 1);
//     the last n % E codes are taken by the first block's threads, one each;
//   * indices are 64-bit; one launch, no scratch, the caller's stream.
// A code becomes its exact float without the conversion unit: the byte is placed in
// the low mantissa of 2^23 (one byte permute) and 2^23 is subtracted.
//
// Rounding follows the host decode (numpy QuantInfo.dequantize): the multiply and
// the add are separate round-to-nearest float ops (__fmul_rn, __fadd_rn), so nvcc
// cannot contract them into an FMA, and the narrowing conversions round to nearest
// even. f64 output is the f32 result widened.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <climits>

namespace {

// Output types as their raw bits; pack() turns 16 bytes' worth of f32 results into
// four 32-bit words without type punning through the half/bfloat16 classes.
struct F32 {
    using raw = uint32_t;
    static __device__ __forceinline__ raw bits(float v) { return __float_as_uint(v); }
    static __device__ __forceinline__ void pack(const float* v, uint32_t* w) {
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(v[i]);
    }
};
struct F16 {
    using raw = uint16_t;
    static __device__ __forceinline__ raw bits(float v) {
        return __half_as_ushort(__float2half_rn(v));
    }
    static __device__ __forceinline__ void pack(const float* v, uint32_t* w) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const __half2 h = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
            w[i] = *reinterpret_cast<const uint32_t*>(&h);
        }
    }
};
struct BF16 {
    using raw = uint16_t;
    static __device__ __forceinline__ raw bits(float v) {
        return __bfloat16_as_ushort(__float2bfloat16_rn(v));
    }
    static __device__ __forceinline__ void pack(const float* v, uint32_t* w) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
            w[i] = *reinterpret_cast<const uint32_t*>(&h);
        }
    }
};
struct F64 {
    using raw = unsigned long long;
    static __device__ __forceinline__ raw bits(float v) {
        return static_cast<raw>(__double_as_longlong(static_cast<double>(v)));
    }
    static __device__ __forceinline__ void pack(const float* v, uint32_t* w) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const double d = static_cast<double>(v[i]);
            w[2 * i] = static_cast<uint32_t>(__double2loint(d));
            w[2 * i + 1] = static_cast<uint32_t>(__double2hiint(d));
        }
    }
};

// E codes loaded as one unit (E = 1, 2, 4, 8 or 16 bytes, E-byte aligned)
template <int E>
struct Codes {
    uint32_t w[(E + 3) / 4];

    __device__ __forceinline__ void load(const uint8_t* p) {
        if constexpr (E == 16) {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
            w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
        } else if constexpr (E == 8) {
            const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
            w[0] = v.x; w[1] = v.y;
        } else if constexpr (E == 4) {
            w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
        } else if constexpr (E == 2) {
            w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
        } else {
            w[0] = __ldg(p);
        }
    }

    // code j as an exact float: 0x4B0000qq is 2^23 + q
    __device__ __forceinline__ float code(int j) const {
        return __uint_as_float(__byte_perm(w[j / 4], 0x4B000000u, 0x7540u | (j % 4))) - 8388608.f;
    }
};

// E results to out: E * out_bytes = 16 * k bytes as k 16-byte stores, or one element
template <typename T, int E>
__device__ __forceinline__ void put(typename T::raw* dst, const float (&v)[E]) {
    if constexpr (E == 1) {
        *dst = T::bits(v[0]);
    } else {
        constexpr int kStores = E * static_cast<int>(sizeof(typename T::raw)) / 16;
        constexpr int kPerStore = E / kStores;  // results a 16-byte store holds
        uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
        for (int k = 0; k < kStores; ++k) {
            uint32_t w[4];
            T::pack(v + k * kPerStore, w);
            d[k] = make_uint4(w[0], w[1], w[2], w[3]);
        }
    }
}

__device__ __forceinline__ float affine(float q, float s, float b) {
    return __fadd_rn(__fmul_rn(q, s), b);
}

constexpr int kThreads = 256;  // dequant_u8.py:THREADS

// Thread t takes groups t, t + stride, ... (stride a multiple of the channels'
// period in groups, or at least `groups` when one period is longer than the work),
// U of them at a time, loads first. Block 0 also takes the last n - groups * E codes.
template <typename T, int E, int U>
__global__ void __launch_bounds__(kThreads)
dequant_u8_kernel(const uint8_t* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, typename T::raw* __restrict__ out,
                  int64_t n, int64_t C, int64_t groups, int64_t stride) {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (t < stride) {
        // the channels of this thread's E codes, the same in every group it takes
        float s[E], b[E];
        int64_t c = (t * E) % C;
#pragma unroll
        for (int j = 0; j < E; ++j) {
            s[j] = __ldg(scale + c);
            b[j] = __ldg(bias + c);
            if (++c == C) c = 0;
        }
        for (int64_t g0 = t; g0 < groups; g0 += U * stride) {
            Codes<E> in[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int64_t g = g0 + u * stride;
                if (g < groups) in[u].load(x + g * E);
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int64_t g = g0 + u * stride;
                if (g < groups) {
                    float v[E];
#pragma unroll
                    for (int j = 0; j < E; ++j) v[j] = affine(in[u].code(j), s[j], b[j]);
                    put<T, E>(out + g * E, v);
                }
            }
        }
    }
    if (blockIdx.x == 0) {
        const int64_t i = groups * E + threadIdx.x;
        if (i < n) {
            const int64_t c = i % C;
            out[i] = T::bits(affine(static_cast<float>(x[i]), __ldg(scale + c), __ldg(bias + c)));
        }
    }
}

template <typename T>
cudaError_t launch(const uint8_t* x, const float* scale, const float* bias, void* out,
                   int64_t n, int64_t C, int vector, int64_t blocks, int64_t stride,
                   cudaStream_t stream) {
    constexpr int E = 16 / static_cast<int>(sizeof(typename T::raw));  // one 16-byte store
    auto* o = static_cast<typename T::raw*>(out);
    const unsigned grid = static_cast<unsigned>(blocks);
    if (!vector) {
        dequant_u8_kernel<T, 1, 32><<<grid, kThreads, 0, stream>>>(x, scale, bias, o, n, C, n, stride);
    } else {
        if (reinterpret_cast<uintptr_t>(x) % E != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
            return cudaErrorInvalidValue;
        dequant_u8_kernel<T, E, 32 / E><<<grid, kThreads, 0, stream>>>(x, scale, bias, o, n, C,
                                                                        n / E, stride);
    }
    return cudaGetLastError();
}

}  // namespace

// out_kind: 0 = float32, 1 = float16, 2 = bfloat16, 3 = float64. vector: 1 for groups
// of 16 / out_bytes codes (x aligned to the group, out to 16 bytes), 0 for single
// codes. blocks of 256 threads and stride (in groups) come from dequant_u8.py:geometry,
// which makes stride a multiple of the channels' period in groups (or at least the
// number of groups) and at most the grid's threads. Returns the cudaError_t of the
// launch (0 = cudaSuccess); 1 (cudaErrorInvalidValue) for an unknown out_kind, a
// non-positive C, a grid that does not fit, or a vector launch on a misaligned pointer.
extern "C" int dequant_u8_launch(const void* x, const void* scale, const void* bias,
                                 void* out, int64_t n, int64_t C, int out_kind, int vector,
                                 int64_t blocks, int64_t stride, void* stream) {
    if (n <= 0) return cudaSuccess;
    if (C <= 0 || blocks < 1 || blocks > INT_MAX || stride < 1 || stride > blocks * kThreads)
        return cudaErrorInvalidValue;
    const uint8_t* xq = static_cast<const uint8_t*>(x);
    const float* s = static_cast<const float*>(scale);
    const float* b = static_cast<const float*>(bias);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (out_kind) {
        case 0: return static_cast<int>(launch<F32>(xq, s, b, out, n, C, vector, blocks, stride, st));
        case 1: return static_cast<int>(launch<F16>(xq, s, b, out, n, C, vector, blocks, stride, st));
        case 2: return static_cast<int>(launch<BF16>(xq, s, b, out, n, C, vector, blocks, stride, st));
        case 3: return static_cast<int>(launch<F64>(xq, s, b, out, n, C, vector, blocks, stride, st));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
