// mbarriers and asynchronous copies into shared memory (PTX, sm_90a),
// shared by the split-T decode attention engine (decode_split.cuh: K2, K7)
// and the fused decoder-layer step (fused_decoder_step.cu: K6).
//
// Two ways a tile reaches shared memory, both counted on an mbarrier:
// - bulk_copy / bulk_copy_2d: the copy engine (TMA) moves a contiguous run
//   of bytes, or a 2-D box of a tensor map, one instruction by one thread;
//   the barrier waits for the bytes announced by mbar_expect.
// - copy16 / copy4: cp.async by every thread, for strided runs; each
//   thread's mbar_arrive_async arrives once its copies have landed, so a
//   barrier taking them is initialised with one count per thread.
// Shared memory that the threads have read and the copy engine rewrites
// next needs fence_proxy_async first (after the block's barrier).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace async_copy {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the one arrival of a bulk phase, which then waits for `bytes` of copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// this thread's arrival, once its stores so far are visible
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// this thread's arrival, once its cp.async copies so far have landed
__device__ __forceinline__ void mbar_arrive_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from 16-byte aligned global to 16-byte aligned
// shared memory by the copy engine, counted on `bar` when they land
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the box of a 2-D tensor map (a CUtensorMap in kernel-parameter, constant
// or global memory) at column c0 (innermost) and row r0, to 128-byte
// aligned shared memory, counted on `bar` when it lands (the whole box:
// rows past the tensor arrive as zeros)
__device__ __forceinline__ void bulk_copy_2d(void* dst, const void* map, int c0, int r0,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(c0), "r"(r0), "r"(smem_addr(bar))
      : "memory");
}

// 16 bytes, global to shared, without passing through registers
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// 4 bytes, global to shared
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// shared memory read by the threads is rewritten by the copy engine next
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace async_copy
