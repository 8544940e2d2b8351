// mma.sync building blocks that the scan's tensor-core kernels share (ssd_scan.cu, the
// forward; ssd_scan_bwd.cu, the backward): the TF32 conversion, bf16 and TF32 mma.sync,
// ldmatrix, cp.async, and the swizzled bf16 slabs they read. _build.py hashes this header
// into both libraries' names, so an edited header rebuilds them. Under the CPU emulator
// (tests/cuda_emu, which defines CUDA_EMU_MMA) the warp-wide instructions are its own;
// cp4 and ldsm_x2, which only the forward uses, have no emulation.
//
// Fragments are mma.sync's: for m16n8k16, lane l (g = l / 4, t = l % 4) holds A's rows g
// and g + 8 at columns 2t, 2t + 1 (and + 8), B's rows 2t, 2t + 1 (and + 8) at column g,
// and the accumulator's rows g and g + 8 at columns 2t, 2t + 1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace mma {

using bf16 = __nv_bfloat16;

#if defined(__CUDACC__)
// f32 -> TF32 (10 mantissa bits), round to nearest even, as bits the mma reads
__device__ __forceinline__ uint32_t tf32(float v) {
    uint32_t r;
    asm("cvt.rn.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
    return r;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// d (16x8 f32) += a (16x16 bf16, row) · b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (16x8 f32) += a (16x8 tf32, row) · b (8x8 tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int PENDING>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(PENDING) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x1_t(uint32_t& r, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];"
                 : "=r"(r) : "r"(smem_u32(p)));
}
#else
using emu::cp16;
using emu::cp_commit;
using emu::cp_wait;
using emu::ldsm_x1_t;
using emu::ldsm_x2_t;
using emu::ldsm_x4;
using emu::ldsm_x4_t;
using emu::mma_bf16;
using emu::mma_tf32;
using emu::tf32;

inline uint32_t pack_bf16(float lo, float hi) {
    return uint32_t(__float2bfloat16_rn(lo).bits) | uint32_t(__float2bfloat16_rn(hi).bits) << 16;
}
#endif

// the f32 bits of the low and high bf16 of a packed pair: exact, and exact in TF32
__device__ __forceinline__ uint32_t lo_bits(uint32_t pair) { return pair << 16; }
__device__ __forceinline__ uint32_t hi_bits(uint32_t pair) { return pair & 0xFFFF0000u; }

// 16-byte chunk c of row `row` of a shared-memory slab whose rows hold CR chunks, XOR-
// swizzled so that the same chunk of 8 consecutive rows (or of rows 2 apart) falls in
// distinct bank groups: ldmatrix and the fragment reads are free of conflicts
template <int CR>
__device__ __forceinline__ int swz(int row, int c) {
    if constexpr (CR >= 8) return c ^ (row & 7);
    else return c ^ ((row / (8 / CR)) & (CR - 1));
}
// element (row, col) of a (Qp, COLS) bf16 slab as TMA writes it: boxes of at most 64
// columns (128 bytes, one swizzle span) by all Qp rows, each row's 16-byte chunks
// XOR-swizzled as TMA's 128/64/32-byte swizzle does (= swz)
template <int COLS>
__device__ __forceinline__ int at(int row, int col, int Qp) {
    constexpr int kBW = COLS < 64 ? COLS : 64;
    return (col / kBW) * Qp * kBW + row * kBW + swz<kBW / 8>(row, (col % kBW) / 8) * 8 + col % 8;
}

// rows [0, Q) of a (rows, COLS) bf16 slab from global memory into a shared slab laid
// out as `at` says, by cp.async, 16 bytes a copy, every thread of the block taking a
// share; rows [Q, Qp) become zeros
template <int COLS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, int Q, int Qp) {
    for (int i = threadIdx.x; i < Q * (COLS / 8); i += blockDim.x) {
        const int r = i / (COLS / 8), c8 = i % (COLS / 8);
        cp16(dst + at<COLS>(r, c8 * 8, Qp), src + static_cast<size_t>(r) * COLS + c8 * 8);
    }
    for (int i = threadIdx.x; i < (Qp - Q) * COLS; i += blockDim.x)
        dst[at<COLS>(Q + i / COLS, i % COLS, Qp)] = __float2bfloat16_rn(0.f);
}

}  // namespace mma
}  // namespace
