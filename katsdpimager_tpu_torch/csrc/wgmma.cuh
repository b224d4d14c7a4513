// Tensor-core helpers for Hopper (sm_90a) shared by K1 (csrc/gridder.cu)
// and the numerics probes (csrc/probe.cu): the TF32 rounding that both
// split their f32 operands with, the shared-memory matrix descriptor, the
// TF32 wgmma.mma_async products and the fences around their asynchronous
// window, the 3xTF32 accumulation schedule that K1 and probe C share
// (wgmma_tf32x3, promote, kPromoteSteps, kSegment), and the barriers of
// K1's producer/consumer ring (mbarrier full/empty pairs, named
// barriers).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The bits of x rounded to TF32 (10 mantissa bits), to nearest, ties away
// from zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// tf32_rna(x) for finite x, as a float, on the integer pipe: half a TF32
// ulp added to the magnitude's bits, the 13 bits below it dropped (the
// rounding fused_gridder.tf32_rna emulates).  Cheaper than the
// conversion in a loop that does little else (K1's producer).
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & ~0x1FFFu);
}

// wgmma.mma_async m64n64k8, TF32 inputs, FP32 accumulation, d += a b
// (kScaleB = 1) or d -= a b (kScaleB = -1); A and B through shared-memory
// matrix descriptors.  scale_d = 0 ignores d's old value.
template <int kScaleB = 1>
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kScaleB));
}

// The tensor cores' FP32 accumulation is not IEEE: a wgmma k8 step
// aligns its eight exact products and the accumulator to the largest
// exponent among them, keeps each to 2 bits past that one's 24-bit
// significand (the lower bits are dropped), and truncates the sum to FP32
// (the model of tests/test_torch_k1_accumulation.py, fitted to four
// readings of probe C on an H100 to within 1%).  Each add loses up to
// ~2^-23 of the largest addend, always towards zero, so the error of a sum
// kept in the accumulators grows with the adds it takes: 1.9e-6 of the
// peak after 96 adds at probe C, 3-4e-6 in K1 after 192.  The schedule
// that K1 and probe C share bounds it: the tensor cores sum kPromoteSteps
// k-steps of 8 (scale_d = 0 starts each such stretch afresh), then the
// CUDA cores add the stretch into FP32 totals in registers by IEEE adds
// (promote): into a segment's total, which goes into the run's total
// every kSegment stretches, so that neither sum's own rounding grows with
// the thousands of stretches of a long run (one total read 1.4-1.7e-6 of
// the peak on runs of 4096 k-steps, two 3.1-4.1e-7).
constexpr int kPromoteSteps = 2;
constexpr int kSegment = 32;

// d = (scale_d ? d : 0) + s (a_lo b_hi + a_hi b_lo + a_hi b_hi), three
// TF32 wgmmas into one accumulator in that order, s = kScaleB (+1 or
// -1): the 3xTF32 product of two f32 operands split into TF32 hi =
// tf32_rna(x) and lo = tf32_rna(x - hi) (lo lo, below 2^-22 of the
// product, is dropped).  Issues only: the caller fences and commits.
template <int kScaleB = 1>
__device__ __forceinline__ void wgmma_tf32x3(float (&d)[32], uint64_t a_hi,
                                             uint64_t a_lo, uint64_t b_hi,
                                             uint64_t b_lo, int scale_d) {
  wgmma_tf32<kScaleB>(d, a_lo, b_hi, scale_d);
  wgmma_tf32<kScaleB>(d, a_hi, b_lo);
  wgmma_tf32<kScaleB>(d, a_hi, b_hi);
}


// total += part by IEEE adds on the CUDA cores, part then zeroed with
// kClear; after the wgmmas that wrote an accumulator part have completed
// (wgmma_wait_all, fence_operands).
template <bool kClear = false, int ND>
__device__ __forceinline__ void promote(float (&total)[ND],
                                        float (&part)[ND]) {
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    total[i] += part[i];
    if (kClear) part[i] = 0.f;
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window.
template <int ND>
__device__ __forceinline__ void fence_operands(float (&d)[ND]) {
#pragma unroll
  for (int i = 0; i < ND; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Makes this thread's shared-memory writes visible to the tensor cores'
// (async proxy) reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of an operand in shared memory: start address, LBO and SBO
// (bytes) and the layout type.  Layout 0, no swizzle: a K-major operand's
// core matrices of 8 rows x 16 bytes stored contiguously, LBO bytes apart
// along K and SBO bytes apart along M or N.  Layout 1: 128-byte swizzle.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo,
                                              uint32_t layout = 0) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// An mbarrier in shared memory that completes a phase when `count`
// threads have arrived (or, with mbar_expect_tx, transfers landed).
// Initialised by one thread, before a CTA barrier; the fence makes the
// initialisation visible to the other threads and the async proxy.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// This thread's arrival (release: its earlier shared-memory writes are
// visible to a thread whose wait sees the phase complete).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// Waits for the phase `parity` of `bar` to complete (acquire); traps (a
// launch error, not a hang) if it has not after ~2^32 cycles, about 2 s.
// A barrier's phase before its first reads as complete with parity 1, so
// a producer's first wait on an empty ring slot passes at once.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1LL << 32)) __trap();
  } while (!done);
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `count` threads, a
// multiple of 32: bar_sync waits for the others, bar_arrive only counts.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

}  // namespace hopper
