// u8 -> float dequantize for Hopper (sm_90a): out[i] = float(q[i]) * scale[c] + bias[c],
// c = i % C, rounded to the output type.
//
// Replaces the TPU kernel src/repro/kernels/dequant_u8.py:dequant_u8_fwd (Pallas,
// (block_rows, C) tiles in VMEM). On this card the work is bound by bytes: one byte
// read and 2-8 bytes written per element, no reuse, far below the card's operation
// rate. So the design moves bytes in the widest units the memory system serves well
// and ignores the row structure (C is 3 for image channels, which would make a row
// tile 3 bytes wide):
//   * the contiguous input is a flat array of n bytes; each thread loads 16 codes as
//     one uint4 and writes 16 outputs with 16-byte vector stores;
//   * a grid-stride loop covers the array with a grid sized to the card;
//   * the tail (n % 16), or the whole array when a pointer is not 16-byte aligned,
//     takes a scalar path;
//   * indices are 64-bit; the channel is derived once per 16 codes with one 64-bit
//     modulo and then stepped, wrapping at C;
//   * scale and bias (C floats each) are read through __ldg and stay in L1.
//
// Rounding follows the host decode (numpy QuantInfo.dequantize): the multiply and
// the add are separate round-to-nearest float ops (__fmul_rn, __fadd_rn), so nvcc
// cannot contract them into an FMA, and the narrowing conversions round to nearest
// even. f64 output is the f32 result widened.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace {

// Output types as their raw bits, so results are packed into uint4 words without
// type punning through the half/bfloat16 classes.
struct F32 {
    using raw = uint32_t;
    static __device__ __forceinline__ raw bits(float v) { return __float_as_uint(v); }
};
struct F16 {
    using raw = uint16_t;
    static __device__ __forceinline__ raw bits(float v) {
        return __half_as_ushort(__float2half_rn(v));
    }
};
struct BF16 {
    using raw = uint16_t;
    static __device__ __forceinline__ raw bits(float v) {
        return __bfloat16_as_ushort(__float2bfloat16_rn(v));
    }
};
struct F64 {
    using raw = unsigned long long;
    static __device__ __forceinline__ raw bits(float v) {
        return static_cast<raw>(__double_as_longlong(static_cast<double>(v)));
    }
};

__device__ __forceinline__ float affine(uint8_t q, const float* __restrict__ scale,
                                        const float* __restrict__ bias, int64_t c) {
    return __fadd_rn(__fmul_rn(static_cast<float>(q), __ldg(scale + c)), __ldg(bias + c));
}

constexpr int kVec = 16;  // codes per uint4 load
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_u8_kernel(const uint8_t* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, typename T::raw* __restrict__ out,
                  int64_t n, int64_t C, int64_t nvec) {
    using Raw = typename T::raw;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;

    // vector body: 16 codes in, 16 * sizeof(Raw) bytes out as uint4 stores
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (int64_t v = tid; v < nvec; v += stride) {
        union {
            uint4 u;
            uint8_t b[kVec];
        } in;
        in.u = __ldg(xv + v);
        const int64_t i = v * kVec;
        int64_t c = i % C;
        union {
            uint4 u[kVec * sizeof(Raw) / 16];
            Raw r[kVec];
        } res;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
            res.r[j] = T::bits(affine(in.b[j], scale, bias, c));
            if (++c == C) c = 0;
        }
        uint4* dst = reinterpret_cast<uint4*>(out + i);
#pragma unroll
        for (int k = 0; k < static_cast<int>(kVec * sizeof(Raw) / 16); ++k) dst[k] = res.u[k];
    }

    // scalar tail (all of the array when nvec == 0)
    for (int64_t i = nvec * kVec + tid; i < n; i += stride) {
        out[i] = T::bits(affine(x[i], scale, bias, i % C));
    }
}

// SM count of the current device, looked up once per device: the attribute query
// costs several microseconds, a large share of a small launch.
cudaError_t sm_count(int* sms) {
    constexpr int kMaxDevices = 64;
    static std::atomic<int> cache[kMaxDevices];
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    int n = device < kMaxDevices ? cache[device].load(std::memory_order_relaxed) : 0;
    if (n == 0) {
        err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
        if (err != cudaSuccess) return err;
        if (device < kMaxDevices) cache[device].store(n, std::memory_order_relaxed);
    }
    *sms = n;
    return cudaSuccess;
}

template <typename T>
cudaError_t launch(const uint8_t* x, const float* scale, const float* bias, void* out,
                   int64_t n, int64_t C, cudaStream_t stream) {
    const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                         (reinterpret_cast<uintptr_t>(out) % 16 == 0);
    const int64_t nvec = aligned ? n / kVec : 0;
    const int64_t tail = n - nvec * kVec;
    const int64_t work = nvec > tail ? nvec : tail;

    int sms = 0;
    cudaError_t err = sm_count(&sms);
    if (err != cudaSuccess) return err;

    int64_t blocks = (work + kThreads - 1) / kThreads;
    const int64_t cap = static_cast<int64_t>(sms) * 8;  // 8 resident blocks of 256 per SM
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;

    dequant_u8_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        x, scale, bias, static_cast<typename T::raw*>(out), n, C, nvec);
    return cudaGetLastError();
}

}  // namespace

// out_kind: 0 = float32, 1 = float16, 2 = bfloat16, 3 = float64.
// Returns the cudaError_t of the launch (0 = cudaSuccess); 1 (cudaErrorInvalidValue)
// for an unknown out_kind or a non-positive C.
extern "C" int dequant_u8_launch(const void* x, const void* scale, const void* bias,
                                 void* out, int64_t n, int64_t C, int out_kind,
                                 void* stream) {
    if (n <= 0) return cudaSuccess;
    if (C <= 0) return cudaErrorInvalidValue;
    const uint8_t* xq = static_cast<const uint8_t*>(x);
    const float* s = static_cast<const float*>(scale);
    const float* b = static_cast<const float*>(bias);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (out_kind) {
        case 0: return static_cast<int>(launch<F32>(xq, s, b, out, n, C, st));
        case 1: return static_cast<int>(launch<F16>(xq, s, b, out, n, C, st));
        case 2: return static_cast<int>(launch<BF16>(xq, s, b, out, n, C, st));
        case 3: return static_cast<int>(launch<F64>(xq, s, b, out, n, C, st));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
