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

}  // namespace dsp
