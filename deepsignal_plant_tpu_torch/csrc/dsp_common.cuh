// Device helpers shared by the port's kernels (fused_bilstm.cu,
// lstm_recurrence.cu). ops/_build.py hashes this header into every
// library's name, so an edit here rebuilds each kernel that includes it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace dsp {

typedef __nv_bfloat16 bf16;

constexpr size_t kMaxSmem = 232448;     // 227 KB, Hopper's per-block limit

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

// the cell update's sigmoid and tanh in f32 from __expf (ex2.approx) and
// __fdividef (rcp.approx): a few ulp from expf and an IEEE division, in a
// fraction of their instructions (with the accurate versions the
// bfloat16 wgmma kernel's cell updates took about as long as its products
// on the H100)
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}
__device__ __forceinline__ float tanh_fast(float x) {
  return __fdividef(2.f, 1.f + __expf(-2.f * x)) - 1.f;
}

// Allow `smem` bytes of dynamic shared memory for `kernel` (needed above
// 48 KB); refuses more than a block can have.
inline cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// c += a @ b on one 16x8x16 tile; fragments as PTX's mma.m16n8k16 defines
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// x as hi + lo, each rounded to tf32 (to nearest, ties away from zero:
// the values cvt.rna.tf32.f32 gives). Integer ops instead of cvt, which
// runs on the conversion pipe at a quarter of the FP32 rate and bound
// the kernels' steps: hi = x + half an ulp of tf32, cut to tf32's 10
// mantissa bits; lo = x - hi is exact in f32. The tensor cores read the
// top 19 bits of a .tf32 operand and ignore the low 13, so lo is passed
// with half an ulp added (rounded) and its low bits left in place.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// c += a @ b on one 16x8x8 tile in tf32; fragments as PTX's mma.m16n8k8
// defines (a: rows gq, gq+8 x columns q, q+4; b: rows q, q+4 x column gq)
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a @ b in 3xTF32: the small terms first, then hi*hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// the A fragment of the m16 x k8 tile at p (row stride ld), split
__device__ __forceinline__ void a_frag_f32(const float* p, int ld,
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[8 * ld], hi[1], lo[1]);
  split_tf32(p[4], hi[2], lo[2]);
  split_tf32(p[8 * ld + 4], hi[3], lo[3]);
}

// wgmma (Hopper's warpgroup product) in tf32, both operands in shared
// memory, K-major with the 128-byte swizzle: rows of kSwK = 32 tf32 (128
// bytes), 8-row atoms of 1,024 bytes aligned to 1,024, the 16-byte chunk
// index of row r XORed with r % 8 (sw_off). The descriptor's SBO is the
// 1,024 bytes between 8-row groups; its LBO is not used by this layout.

constexpr int kSwK = 32;

// the offset (floats) of element (r, k) of such a tile
__device__ __forceinline__ int sw_off(int r, int k) {
  return r * kSwK + ((((k >> 2) ^ r) & 7) << 2) + (k & 3);
}

// `p` rounded up to a 1,024-byte boundary of shared memory (a dynamic
// shared buffer needs 1,024 bytes of room for it)
__device__ __forceinline__ float* sw_align(unsigned char* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return reinterpret_cast<float*>(p + ((1024 - a) & 1023));
}

__device__ __forceinline__ uint64_t gmma_desc(const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return (uint64_t)((a >> 4) & 0x3FFF) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;   // 128B swizzle
}

// the same for a K-major tile of 64-byte rows in the 64-byte swizzle (the
// 16-byte chunk c of row r at chunk c ^ ((r >> 1) & 3); 8-row atoms of
// 512 bytes, the SBO)
__device__ __forceinline__ uint64_t gmma_desc64(const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return (uint64_t)((a >> 4) & 0x3FFF) | (uint64_t)1 << 16 |
         (uint64_t)(512 >> 4) << 32 | (uint64_t)2 << 62;   // 64B swizzle
}

// d (64 x 128 f32 in the m64n128 accumulator layout) += a (64 x 8) @ b
// (8 x 128), a and b tf32 in shared memory (descriptors). Asynchronous:
// wgmma_commit, then wgmma_wait before d is read or the operands change.
__device__ __forceinline__ void wgmma_tf32_m64n128(float (&d)[64],
                                                   uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}"
      ", %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// orders this thread's shared-memory writes before the async proxy's
// (wgmma's) reads of them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the two halves of a cluster barrier: arrive (release: this thread's
// writes, to its own and to peers' shared memory, are ordered before
// the peers' reads that follow their wait) and wait (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16-byte asynchronous copy global -> shared (cp.async, L2 only); with
// `valid` false it reads nothing and writes 16 zero bytes (src must still
// be a mapped address). Completion: cp_async_commit, then cp_async_wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Row stride of a shared bf16 operand buffer, in elements, for rows of Kp
// (a multiple of 32) elements: a multiple of 8 (16-byte loads) whose byte
// size is an odd multiple of 64, so the 8 threads of a quarter warp (two
// rows, 64 bytes each) cover all 32 banks once.
inline int smem_stride(int Kp) { return Kp % 64 == 0 ? Kp + 32 : Kp; }

// acc[g][r] += sum_k in[k][rg + r] * w[k][g*H + j] over k in [0, K): the
// float32 CUDA-core product of the port's LSTM kernels, with `in`
// transposed in shared memory ([k][row], BB rows) so one 16-byte load
// feeds four rows, and w a (K, 4H) row-major matrix in global memory.
template <int RB>
__device__ __forceinline__ void accumulate(float (&acc)[4][RB],
                                           const float* __restrict__ in,
                                           const float* __restrict__ w, int K,
                                           int H, int BB, int rg, int j) {
  const int G4 = 4 * H;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float* wk = w + (size_t)k * G4 + j;
    const float w0 = wk[0];
    const float w1 = wk[H];
    const float w2 = wk[2 * H];
    const float w3 = wk[3 * H];
    const float* ik = in + k * BB + rg;
#pragma unroll
    for (int r = 0; r < RB; r += 4) {
      const float4 v = *reinterpret_cast<const float4*>(ik + r);
      acc[0][r] += v.x * w0; acc[0][r + 1] += v.y * w0;
      acc[0][r + 2] += v.z * w0; acc[0][r + 3] += v.w * w0;
      acc[1][r] += v.x * w1; acc[1][r + 1] += v.y * w1;
      acc[1][r + 2] += v.z * w1; acc[1][r + 3] += v.w * w1;
      acc[2][r] += v.x * w2; acc[2][r + 1] += v.y * w2;
      acc[2][r + 2] += v.z * w2; acc[2][r + 3] += v.w * w2;
      acc[3][r] += v.x * w3; acc[3][r + 1] += v.y * w3;
      acc[3][r + 2] += v.z * w3; acc[3][r + 3] += v.w * w3;
    }
  }
}

// Warp-specialised kernels (a producer warp streaming tiles by TMA bulk
// copies into a ring of shared-memory stages, consumer warpgroups):
// the ring's mbarriers, the copies, the cluster and the consumers'
// named barrier (fused_bilstm.cu's wgmma kernel, lstm_recurrence.cu's
// K1 float32 recurrence).

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
// arrive on this block's barrier and expect `bytes` more of copies
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// a wait that outlasts this traps (the launch fails, and the wrapper
// raises) rather than holding the card: no phase of the kernels that wait takes
// more than milliseconds
constexpr uint64_t kWaitTrapNs = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t n = 1;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if ((n & 1023) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (t0 == 0)
        t0 = now;
      else if (now - t0 > kWaitTrapNs)
        __trap();
    }
  }
}

// arrive on the barrier at the same offset in block `rank` of the cluster
// (release at CTA scope, as the arrival's default: it orders this
// thread's completed reads; a .release.cluster arrival cost more than
// the stage's wgmmas on the H100)
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n"
      :: "r"(bar), "r"(rank) : "memory");
}

// arrive on this block's barrier
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// TMA bulk copy global -> this block's shared memory, or (mask) to the
// same offset in each block of the cluster in the mask; completes `bytes`
// on the barrier at `bar` of each destination block
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
__device__ __forceinline__ void bulk_load_multicast(uint32_t dst,
                                                    const void* src,
                                                    uint32_t bytes,
                                                    uint32_t bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar), "h"(mask) : "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}
__device__ __forceinline__ void cluster_sync_all() {
  cluster_arrive();
  cluster_wait();
}
// the 256 consumer threads (named barrier 1; the producer warp is not in it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

}  // namespace dsp
