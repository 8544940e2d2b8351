// Hopper (sm_90a) building blocks that the tensor-core attention kernels share:
// mbarriers, TMA tile and bulk loads, wgmma descriptors and products, named
// barriers, and the driver's tensor-map encoder. flash_attention.cu (forward) and
// flash_attention_bwd.cu (backward) include it; _build.py hashes it into both
// libraries' names, so an edited header rebuilds them.
//
// Tiles live in shared memory as TMA writes them: a bf16 (rows, HD) tile is stored
// as boxes of kBoxCols columns (one swizzle span: 128 bytes a row, 64 at hd 32) by
// all of its rows, box after box. Such a tile is read by wgmma two ways:
//   * K-major (the contraction runs along the tile's columns, as Q and K in
//     Q·Kᵀ): a k16 step inside a box advances the start address by 32 bytes, a new
//     box by the box's size; 8-row groups (one swizzle atom) are kAtomBytes apart;
//   * MN-major (the contraction runs along the tile's rows, as V in P·V): 16 rows
//     a k16 step, the boxes of 64 columns a box apart (the leading byte offset),
//     8-row groups an atom apart, through the transpose bit of 16-bit B operands.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver's encoder is reached through
                   // cudaGetDriverEntryPoint, so a library needs no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace sm90 {

// A width as the tiles hold it: whole 64-column boxes from 64 on (112 -> 128: TMA
// zero-fills the columns past the tensor's own, so they add nothing to a product
// over them and give output columns that are not stored).
__host__ __device__ constexpr int padded(int d) { return d < 64 ? d : (d + 63) / 64 * 64; }

// Geometry of a swizzled bf16 tile with HD columns.
template <int HD>
struct Tile {
    static constexpr int kRowBytes = HD * 2 < 128 ? HD * 2 : 128;  // a row of one box
    static constexpr int kBoxCols = kRowBytes / 2;
    static constexpr int kBoxes = HD / kBoxCols;
    // a ragged last box would never be loaded: a tile holds a width padded to whole
    // boxes (112 as 128: flash_attention.cu, padded), and TMA zero-fills the rest
    static_assert(HD % kBoxCols == 0, "a tile's width is a whole number of boxes");
    static constexpr int kAtomBytes = 8 * kRowBytes;  // 8 rows: one swizzle atom
    static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;  // descriptor: 128B / 64B swizzle
    __host__ __device__ static constexpr int box(int rows) { return rows * kRowBytes; }  // one box
    __host__ __device__ static constexpr int bytes(int rows) { return rows * HD * 2; }  // the tile
};

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

// named barrier `id` (1-15; 0 is __syncthreads) over `count` threads: sync waits,
// arrive only counts this thread in
__device__ __forceinline__ void named_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
    asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(count) : "memory");
}

// one box of a 3-D tensor map at element coordinates (c0, c1, c2) into shared
// memory; completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, from a 16-byte aligned address) into
// shared memory; completion is counted in bytes on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint64_t layout) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
           static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | layout << 62;
}

// K-major operand: rows [r0, r0 + 64) (or all N rows of a B operand: r0 = 0) of a
// tile of `rows` rows at `tile`, columns [16 ks, 16 ks + 16)
template <int HD>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int r0, int ks) {
    using T = Tile<HD>;
    const int x = ks * 16 / T::kBoxCols;
    const int off = (ks * 16 % T::kBoxCols) * 2;
    return desc(tile + x * T::box(rows) + r0 * T::kRowBytes + off, 16, T::kAtomBytes, T::kLayout);
}

// MN-major operand: rows [16 kk, 16 kk + 16) of a tile of `rows` rows at `tile`, by
// its columns from box `x0` on (box 2 is column 128: the upper half at hd 256)
template <int HD>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int kk, int x0 = 0) {
    using T = Tile<HD>;
    return desc(tile + x0 * T::box(rows) + kk * 16 * T::kRowBytes, T::box(rows), T::kAtomBytes,
                T::kLayout);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// returns once at most N of this warpgroup's committed wgmma groups still run
// (groups retire in order)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }

// Keep the compiler from moving reads or writes of registers that an in-flight
// wgmma owns across the fence / wait around it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// An m64nN f32 accumulator as wgmma's bf16 register A operand of the next product
// (its k axis the accumulator's columns): for columns 16kk..16kk+15 the four words
// are the consecutive pairs of c[8kk .. 8kk+7].
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 4], const float (&c)[N / 2]) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) a[i] = pack_bf16(c[2 * i], c[2 * i + 1]);
}

// d (64 x 128) (+)= A (64 x 16, shared memory) * B (128 x 16, shared memory)^T, both K-major
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63" "}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) (+)= A (64 x 16, shared memory) * B (64 x 16, shared memory)^T, both K-major
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31" "}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 32) (+)= A (64 x 16, shared memory) * B (32 x 16, shared memory)^T, both K-major
__device__ __forceinline__ void mma_ss_n32(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15" "}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N) (+)= A (64 x 16) · B (N x 16)ᵀ, both from shared memory, K-major
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int accumulate) {
    if constexpr (N == 128) mma_ss_n128(d, a, b, accumulate);
    else if constexpr (N == 64) mma_ss_n64(d, a, b, accumulate);
    else mma_ss_n32(d, a, b, accumulate);
}

// d (64 x 128) += A (64 x 16, registers) * B (16 x 128, shared memory, N-major)
__device__ __forceinline__ void mma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63" "}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64) += A (64 x 16, registers) * B (16 x 64, shared memory, N-major)
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31" "}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 32) += A (64 x 16, registers) * B (16 x 32, shared memory, N-major)
__device__ __forceinline__ void mma_rs_n32(float (&d)[16], const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15" "}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O (64 x HD) += P (64 x 16 keys, registers) · V (16 keys x HD, shared memory).
// At hd 256 two N = 128 products: columns 0-127 (registers 0-63, V's boxes 0-1,
// descriptor v) and 128-255 (registers 64-127, boxes 2-3, descriptor v_hi); at 192
// (MLA's q·k width, in the backward's dQ and dK) an N = 128 and an N = 64 product,
// the second over box 2 (registers 64-95).
template <int HD>
__device__ __forceinline__ void mma_pv(float (&o)[HD / 2], const uint32_t* p, uint64_t v,
                                       uint64_t v_hi) {
    if constexpr (HD == 256) {
        mma_rs_n128(*reinterpret_cast<float (*)[64]>(&o[0]), p, v);
        mma_rs_n128(*reinterpret_cast<float (*)[64]>(&o[64]), p, v_hi);
    } else if constexpr (HD == 192) {
        mma_rs_n128(*reinterpret_cast<float (*)[64]>(&o[0]), p, v);
        mma_rs_n64(*reinterpret_cast<float (*)[32]>(&o[64]), p, v_hi);
    } else if constexpr (HD == 128) {
        mma_rs_n128(o, p, v);
    } else if constexpr (HD == 64) {
        mma_rs_n64(o, p, v);
    } else {
        mma_rs_n32(o, p, v);
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded; null if absent
inline EncodeTiled encode_tiled() {
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

// Makes the primary context of the device that holds `ptr` current in this thread.
// The driver's tensor-map encoder needs a current context, and a thread that has
// made no runtime call yet may have none (autograd's device thread, when the
// allocator serves it from its cache): the encoder then fails with
// CUDA_ERROR_INVALID_CONTEXT. A launch that encodes maps calls this first.
inline cudaError_t bind_device_of(const void* ptr) {
    cudaPointerAttributes attr;
    const cudaError_t err = cudaPointerGetAttributes(&attr, ptr);
    return err == cudaSuccess ? cudaSetDevice(attr.device) : err;
}

// A bf16 tensor of `heads` contiguous (rows, hd) slabs as a 3-D map (hd, rows,
// heads) whose box is (box_cols, box_rows, 1), swizzled across box_cols * 2 bytes.
// A box that runs past `rows` is zero-filled there and never reads the next head.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int hd, int rows, int heads,
                            int box_cols, int box_rows) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(rows),
                                static_cast<cuuint64_t>(heads)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                   static_cast<cuuint64_t>(rows) * hd * 2};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                               static_cast<cuuint32_t>(box_rows), 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    const CUresult res = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
        unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
        box_cols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace
