// Fused bidirectional LSTM layer, time-major, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel deepsignal_plant_tpu/ops/pallas_fused.py
// ::_fused_kernel (reached through _layer_fused_impl's pallas_call). One
// launch computes one whole layer, both directions, input projection
// included:
//
//     pre_d[t] = sum_i x_i[t] @ W_ih[d][rows_i] + b[d] + h_d @ W_hh[d]
//     i,f,o = sigmoid(pre[i|f|o]), g = tanh(pre[g])   (gate order i,f,g,o)
//     c = f*c + i*g ; h = o*tanh(c)                   (zero initial h, c)
//
// Direction 1 reads x at time T-1-s in its step s and writes its state at
// row T-1-s, so both outputs come out in true time. The input arrives as
// one or two row-split arrays (xa against W_ih rows [0,Fa), xb against
// [Fa,Fa+Fb)), so a layer fed by the previous layer's (fwd, bwd) halves
// never needs a concatenation in device memory. seq_out=0 writes only the
// (1,B,H) final states.
//
// Numerics contract (pallas_fused.py:78-101, :214-215, :243-245): x, W
// and h are stored in float32 or bfloat16; products accumulate in f32,
// the bias is f32, gate math and the cell state are f32; h is rounded to
// the storage type after every step (it is the next step's operand) and
// outputs are stored in that type.
//
// Design. The TPU kernel walks a sequential grid axis over T and keeps h
// and c in VMEM scratch between grid steps. Hopper runs blocks in no
// order, so the time loop lives inside the block instead: grid =
// (ceil(B / BB), 2 directions), and a block owns BB batch rows of one
// direction for all T steps. Every thread computes all four gate
// pre-activations (columns j, H+j, 2H+j, 3H+j) of the hidden units it
// owns, so the cell update needs no exchange between threads; c stays in
// registers (f32) for the whole sequence; h_{t-1} is exchanged through
// shared memory. The weights are read from global memory: one direction's
// W_hh alone is 512 KB in bf16 at H=256, more than the 227 KB of shared
// memory, and a comb layer's ~3 MB of weights stay in the 50 MB L2 across
// blocks and steps. The ragged batch edge is masked in the kernel (rows
// >= B read zeros and store nothing); no padding on the host.
//
// One kernel per storage type:
//
// bfloat16 (the main path): tensor cores through mma.sync m16n8k16 (bf16
//   in, f32 accumulate). BB = 32 rows (two m16 tiles), up to 8 warps. A
//   warp owns groups of 8 hidden units; for a group it accumulates four
//   16x8 tiles per m16 tile, one per gate, over the same 8 units, so a
//   thread's accumulator fragments hold i, f, g and o of the same (row,
//   unit) pairs. The A operand, [x_t | h_{t-1}] of the block's rows in
//   bf16, is double-buffered in shared memory: step s reads one buffer,
//   writes h_s and stages x_{s+1} into the other, so one __syncthreads()
//   per step suffices. The B operand is the direction's [W_ih; W_hh],
//   transposed to (4H, K) and zero-padded to K = round_up(F+H, 32) by a
//   packing kernel into the caller's workspace, so one 16-byte load gives
//   a thread its fragments of two k16 steps (the k index is permuted
//   alike in A and B, which leaves the sum unchanged).
// float32: CUDA-core FMAs. block = (round_up(H, 32), max(1, 256 / that))
//   threads; thread (j, y) owns unit j for RB = 16 rows; x_t and h_{t-1}
//   are staged as f32, transposed ([k][row]) so one 16-byte load feeds
//   four rows; two __syncthreads() per step order the h exchange.
//
// What bounds it. Per step and direction the layer is a (BB x (F+H)) by
// ((F+H) x 4H) product, and T=13 steps run in sequence. At the main
// path's comb layers (F=512, H=256, B=4096) a layer is 2*2*T*B*(F+H)*4H =
// 168 GFLOP against ~0.1 GB of compulsory traffic: bound by operations
// (0.17 ms at the bf16 tensor-core peak), not by bytes (0.03 ms).
//
// What this design gives up. Every block re-reads its direction's
// weights from L2 at every step (1.5 MB a step at a comb layer, ~5 GB a
// layer at B=4096), so L2 bandwidth rather than the tensor cores sets its
// floor, and mma.sync runs below wgmma's rate. The faster design (wgmma
// on weight tiles held in shared memory across a thread-block cluster,
// gate columns split between the cluster's blocks, h shared through
// distributed shared memory) is later work. The float32 kernel runs on
// the CUDA cores (67 TFLOP/s peak) and serves exact-parity runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr size_t kMaxSmem = 232448;     // 227 KB, Hopper's per-block limit

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs

constexpr int kRowsPerThread = 16;      // RB: rows of one thread
constexpr int kMaxBlockThreads = 512;   // H <= 512
constexpr int kTargetThreads = 256;

// acc[g][r] += sum_k in[k][rg + r] * w[k][g*H + j] over k in [0, K)
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

template <int RB>
__global__ void __launch_bounds__(kMaxBlockThreads)
fused_bilstm_f32_kernel(const float* __restrict__ xa,
                        const float* __restrict__ xb,
                        const float* __restrict__ w_ih,
                        const float* __restrict__ bias,
                        const float* __restrict__ w_hh,
                        float* __restrict__ ys_f, float* __restrict__ ys_b,
                        int T_, int B, int Fa, int Fb, int H, int seq_out) {
  extern __shared__ __align__(16) float smem[];
  const int d = blockIdx.y;
  const int F = Fa + Fb;
  const int G4 = 4 * H;
  const int BB = RB * blockDim.y;           // batch rows of this block
  const int b0 = blockIdx.x * BB;
  const int j = threadIdx.x;                // hidden unit of this thread
  const int rg = threadIdx.y * RB;          // its first row in the block
  const bool active = j < H;
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  float* xs = smem;                         // [F][BB]: x_t, transposed
  float* hs = smem + F * BB;                // [H][BB]: h_{t-1}, transposed

  const float* wi = w_ih + (size_t)d * F * G4;
  const float* wh = w_hh + (size_t)d * H * G4;
  float* ys = d == 0 ? ys_f : ys_b;

  float bg[4] = {0.f, 0.f, 0.f, 0.f};
  if (active) {
#pragma unroll
    for (int g = 0; g < 4; ++g) bg[g] = bias[d * G4 + g * H + j];
  }
  float c[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) c[r] = 0.f;
  for (int i = tid; i < H * BB; i += nthreads) hs[i] = 0.f;

  for (int s = 0; s < T_; ++s) {
    const int t = d == 0 ? s : T_ - 1 - s;
    // stage x_t of the block's rows; rows past the batch edge read zeros
    for (int i = tid; i < BB * F; i += nthreads) {
      const int r = i / F;
      const int k = i - r * F;
      const int row = b0 + r;
      float v = 0.f;
      if (row < B) {
        v = k < Fa ? xa[((size_t)t * B + row) * Fa + k]
                   : xb[((size_t)t * B + row) * Fb + (k - Fa)];
      }
      xs[k * BB + r] = v;
    }
    __syncthreads();                        // x_t staged, h_{t-1} written

    float acc[4][RB];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[g][r] = bg[g];
    }
    if (active) {
      accumulate<RB>(acc, xs, wi, F, H, BB, rg, j);
      accumulate<RB>(acc, hs, wh, H, H, BB, rg, j);
    }
    __syncthreads();                        // every read of h_{t-1} done

    if (active) {
      const bool store = seq_out || s == T_ - 1;
      const int t_out = seq_out ? t : 0;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float ig = sigmoid_f(acc[0][r]);
        const float fg = sigmoid_f(acc[1][r]);
        const float gg = tanhf(acc[2][r]);
        const float og = sigmoid_f(acc[3][r]);
        c[r] = fg * c[r] + ig * gg;
        const float h = og * tanhf(c[r]);
        hs[j * BB + rg + r] = h;
        const int row = b0 + rg + r;
        if (store && row < B) ys[((size_t)t_out * B + row) * H + j] = h;
      }
    }
  }
}

cudaError_t launch_f32(const float* xa, const float* xb, const float* w_ih,
                       const float* bias, const float* w_hh, float* ys_f,
                       float* ys_b, int T_, int B, int Fa, int Fb, int H,
                       int seq_out, cudaStream_t stream) {
  const int bx = (H + 31) / 32 * 32;
  const int by = bx >= kTargetThreads ? 1 : kTargetThreads / bx;
  const int BB = kRowsPerThread * by;
  const size_t smem = (size_t)(Fa + Fb + H) * BB * sizeof(float);
  auto kernel = fused_bilstm_f32_kernel<kRowsPerThread>;
  const cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + BB - 1) / BB, 2);
  kernel<<<grid, dim3(bx, by), smem, stream>>>(xa, xb, w_ih, bias, w_hh, ys_f,
                                               ys_b, T_, B, Fa, Fb, H,
                                               seq_out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16)

constexpr int kMmaTiles = 2;                  // MT: m16 tiles of a block
constexpr int kMmaRows = 16 * kMmaTiles;      // BB
constexpr int kMmaWarps = 8;

// K of the packed weights: F + H rounded up to the k32 step
inline int padded_k(int F, int H) { return (F + H + 31) / 32 * 32; }

// Row stride of the shared A buffers, in elements: a multiple of 8 (16-byte
// loads) whose byte size is an odd multiple of 64, so the 8 threads of a
// quarter warp (two rows, 64 bytes each) cover all 32 banks once.
inline int smem_stride(int Kp) { return Kp % 64 == 0 ? Kp + 32 : Kp; }

// wt[d][n][k] = [W_ih[d]; W_hh[d]][k][n] for k < F + H, 0 up to Kp
__global__ void pack_weights_kernel(const bf16* __restrict__ w_ih,
                                    const bf16* __restrict__ w_hh,
                                    bf16* __restrict__ wt, int F, int H,
                                    int Kp) {
  const int G4 = 4 * H;
  const size_t total = (size_t)2 * G4 * Kp;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int k = (int)(i % Kp);
    const size_t dn = i / Kp;
    const int n = (int)(dn % G4);
    const int d = (int)(dn / G4);
    bf16 v = __float2bfloat16_rn(0.f);
    if (k < F) v = w_ih[((size_t)d * F + k) * G4 + n];
    else if (k < F + H) v = w_hh[((size_t)d * H + (k - F)) * G4 + n];
    wt[i] = v;
  }
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

// x_t of the block's rows into columns [0, F) of an A buffer; rows past
// the batch edge read zeros. 16-byte loads where both inputs allow them
// (widths a multiple of 8, 16-byte aligned bases).
__device__ __forceinline__ void stage_x(bf16* __restrict__ buf,
                                        const bf16* __restrict__ xa,
                                        const bf16* __restrict__ xb, int t,
                                        int B, int b0, int Fa, int Fb, int Ks) {
  const int F = Fa + Fb;
  const bool aligned = reinterpret_cast<uintptr_t>(xa) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(xb) % 16 == 0;
  if (aligned && Fa % 8 == 0 && Fb % 8 == 0) {
    const int F8 = F / 8;
    for (int i = threadIdx.x; i < kMmaRows * F8; i += blockDim.x) {
      const int r = i / F8;
      const int k = (i - r * F8) * 8;
      const int row = b0 + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row < B) {
        v = k < Fa ? *reinterpret_cast<const uint4*>(
                         xa + ((size_t)t * B + row) * Fa + k)
                   : *reinterpret_cast<const uint4*>(
                         xb + ((size_t)t * B + row) * Fb + (k - Fa));
      }
      *reinterpret_cast<uint4*>(buf + r * Ks + k) = v;
    }
    return;
  }
  for (int i = threadIdx.x; i < kMmaRows * F; i += blockDim.x) {
    const int r = i / F;
    const int k = i - r * F;
    const int row = b0 + r;
    bf16 v = __float2bfloat16_rn(0.f);
    if (row < B) {
      v = k < Fa ? xa[((size_t)t * B + row) * Fa + k]
                 : xb[((size_t)t * B + row) * Fb + (k - Fa)];
    }
    buf[r * Ks + k] = v;
  }
}

// GPW: unit groups (of 8) per warp; a thread keeps GPW*MT*4 cell states
template <int GPW>
__global__ void __launch_bounds__(kMmaWarps * 32, GPW <= 4 ? 2 : 1)
fused_bilstm_bf16_kernel(const bf16* __restrict__ xa,
                         const bf16* __restrict__ xb,
                         const bf16* __restrict__ wt,
                         const float* __restrict__ bias,
                         bf16* __restrict__ ys_f, bf16* __restrict__ ys_b,
                         int T_, int B, int Fa, int Fb, int H, int Kp,
                         int Ks, int seq_out) {
  constexpr int MT = kMmaTiles;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const buf0 = reinterpret_cast<bf16*>(smem_raw);
  bf16* const buf1 = buf0 + kMmaRows * Ks;
  const int d = blockIdx.y;
  const int F = Fa + Fb;
  const int G4 = 4 * H;
  const int b0 = blockIdx.x * kMmaRows;
  const int nwarps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int gq = (threadIdx.x % 32) >> 2;   // groupID of the fragments
  const int q = threadIdx.x & 3;            // thread in the group
  const int ngroups = (H + 7) / 8;
  const bf16* w = wt + (size_t)d * G4 * Kp;
  bf16* ys = d == 0 ? ys_f : ys_b;

  // h_{-1} = 0 and the pad columns [F+H, Kp) = 0 in both buffers
  for (int i = threadIdx.x; i < 2 * kMmaRows * Ks / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  stage_x(buf0, xa, xb, d == 0 ? 0 : T_ - 1, B, b0, Fa, Fb, Ks);
  __syncthreads();

  float c[GPW][MT][4];
#pragma unroll
  for (int gi = 0; gi < GPW; ++gi)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[gi][mt][e] = 0.f;

  for (int s = 0; s < T_; ++s) {
    const int t = d == 0 ? s : T_ - 1 - s;
    const bf16* cur = s & 1 ? buf1 : buf0;
    bf16* nxt = s & 1 ? buf0 : buf1;
    if (s + 1 < T_)
      stage_x(nxt, xa, xb, d == 0 ? s + 1 : T_ - 2 - s, B, b0, Fa, Fb, Ks);
    const bool store = seq_out || s == T_ - 1;
    const int t_out = seq_out ? t : 0;

#pragma unroll
    for (int gi = 0; gi < GPW; ++gi) {
      const int grp = warp + gi * nwarps;
      if (grp >= ngroups) break;            // the same for the whole warp
      const int j0 = grp * 8;
      // B fragments: this thread loads column gate*H + j0 + gq
      const bool bvalid = j0 + gq < H;
      const bf16* wrow = w + (size_t)(j0 + gq) * Kp + 8 * q;
      // accumulator fragments: units u and u + 1 of every gate
      const int u = j0 + 2 * q;
      float acc[MT][4][4];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        const float b_lo = u < H ? bias[d * G4 + gate * H + u] : 0.f;
        const float b_hi = u + 1 < H ? bias[d * G4 + gate * H + u + 1] : 0.f;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc[mt][gate][0] = b_lo; acc[mt][gate][1] = b_hi;
          acc[mt][gate][2] = b_lo; acc[mt][gate][3] = b_hi;
        }
      }
      // k32 steps: thread q holds k = k0 + 8q .. 8q+7 of A and B; the first
      // four feed one mma (as its k slots 2q, 2q+1, 2q+8, 2q+9), the last
      // four the other
#pragma unroll 2
      for (int k0 = 0; k0 < Kp; k0 += 32) {
        uint4 bq[4];
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) {
          bq[gate] = bvalid ? *reinterpret_cast<const uint4*>(
                                  wrow + (size_t)gate * H * Kp + k0)
                            : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const bf16* arow = cur + (mt * 16 + gq) * Ks + k0 + 8 * q;
          const uint4 lo = *reinterpret_cast<const uint4*>(arow);
          const uint4 hi = *reinterpret_cast<const uint4*>(arow + 8 * Ks);
#pragma unroll
          for (int gate = 0; gate < 4; ++gate) {
            mma_bf16(acc[mt][gate], lo.x, hi.x, lo.y, hi.y, bq[gate].x,
                     bq[gate].y);
            mma_bf16(acc[mt][gate], lo.z, hi.z, lo.w, hi.w, bq[gate].z,
                     bq[gate].w);
          }
        }
      }
      // fragment element e: row gq + 8*(e/2) of the tile, unit u + e%2
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ig = sigmoid_f(acc[mt][0][e]);
          const float fg = sigmoid_f(acc[mt][1][e]);
          const float gg = tanhf(acc[mt][2][e]);
          const float og = sigmoid_f(acc[mt][3][e]);
          c[gi][mt][e] = fg * c[gi][mt][e] + ig * gg;
          const bf16 h = __float2bfloat16_rn(og * tanhf(c[gi][mt][e]));
          const int r = mt * 16 + gq + (e >> 1) * 8;
          const int j = u + (e & 1);
          if (j < H) {
            nxt[r * Ks + F + j] = h;
            if (store && b0 + r < B)
              ys[((size_t)t_out * B + b0 + r) * H + j] = h;
          }
        }
      }
    }
    __syncthreads();                        // h_s and x_{s+1} are in nxt
  }
}

template <int GPW>
cudaError_t launch_bf16_kernel(const bf16* xa, const bf16* xb, const bf16* wt,
                               const float* bias, bf16* ys_f, bf16* ys_b,
                               int T_, int B, int Fa, int Fb, int H, int Kp,
                               int seq_out, cudaStream_t stream) {
  const int Ks = smem_stride(Kp);
  const size_t smem = (size_t)2 * kMmaRows * Ks * sizeof(bf16);
  auto kernel = fused_bilstm_bf16_kernel<GPW>;
  const cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  const int nwarps = ((H + 7) / 8 + GPW - 1) / GPW;
  const dim3 grid((B + kMmaRows - 1) / kMmaRows, 2);
  kernel<<<grid, nwarps * 32, smem, stream>>>(xa, xb, wt, bias, ys_f, ys_b,
                                              T_, B, Fa, Fb, H, Kp, Ks,
                                              seq_out);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const bf16* xa, const bf16* xb, const bf16* w_ih,
                        const float* bias, const bf16* w_hh, bf16* ys_f,
                        bf16* ys_b, int T_, int B, int Fa, int Fb, int H,
                        int seq_out, bf16* wt, cudaStream_t stream) {
  const int F = Fa + Fb;
  const int Kp = padded_k(F, H);
  const size_t total = (size_t)2 * 4 * H * Kp;
  const int pack_blocks = (int)(total / 256 + 1 < 1024 ? total / 256 + 1
                                                        : 1024);
  pack_weights_kernel<<<pack_blocks, 256, 0, stream>>>(w_ih, w_hh, wt, F, H,
                                                       Kp);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the fewest unit groups per warp that keep a block at <= 8 warps
  const int ngroups = (H + 7) / 8;
  if (ngroups <= kMmaWarps)
    return launch_bf16_kernel<1>(xa, xb, wt, bias, ys_f, ys_b, T_, B, Fa, Fb,
                                 H, Kp, seq_out, stream);
  if (ngroups <= 2 * kMmaWarps)
    return launch_bf16_kernel<2>(xa, xb, wt, bias, ys_f, ys_b, T_, B, Fa, Fb,
                                 H, Kp, seq_out, stream);
  if (ngroups <= 4 * kMmaWarps)
    return launch_bf16_kernel<4>(xa, xb, wt, bias, ys_f, ys_b, T_, B, Fa, Fb,
                                 H, Kp, seq_out, stream);
  return launch_bf16_kernel<8>(xa, xb, wt, bias, ys_f, ys_b, T_, B, Fa, Fb, H,
                               Kp, seq_out, stream);
}

}  // namespace

extern "C" {

// Bytes of the workspace dsp_fused_bilstm_layer needs: the packed
// bfloat16 weights (2, 4H, round_up(Fa+Fb+H, 32)); none for float32.
size_t dsp_fused_bilstm_workspace_bytes(int Fa, int Fb, int H, int dtype) {
  if (dtype != 1) return 0;
  return (size_t)2 * 4 * H * padded_k(Fa + Fb, H) * sizeof(bf16);
}

// x*: (T, B, F*) row-major; w_ih (2, Fa+Fb, 4H); w_hh (2, H, 4H); bias
// (2, 4H) f32; ys_f/ys_b (T or 1, B, H). dtype 0 = float32, 1 = bfloat16;
// workspace: dsp_fused_bilstm_workspace_bytes() bytes, 16-byte aligned.
// Runs on `stream`, allocates nothing, returns the launch's error code.
cudaError_t dsp_fused_bilstm_layer(const void* xa, const void* xb,
                                   const void* w_ih, const void* bias,
                                   const void* w_hh, void* ys_f, void* ys_b,
                                   int T_, int B, int Fa, int Fb, int H,
                                   int seq_out, int dtype, void* workspace,
                                   void* stream) {
  if (T_ < 1 || B < 1 || Fa < 1 || Fb < 0 || H < 1 ||
      H > kMaxBlockThreads || (Fb > 0 && xb == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(static_cast<const float*>(xa),
                      static_cast<const float*>(xb),
                      static_cast<const float*>(w_ih),
                      static_cast<const float*>(bias),
                      static_cast<const float*>(w_hh),
                      static_cast<float*>(ys_f), static_cast<float*>(ys_b),
                      T_, B, Fa, Fb, H, seq_out, s);
  if (dtype == 1) {
    if (workspace == nullptr) return cudaErrorInvalidValue;
    return launch_bf16(static_cast<const bf16*>(xa),
                       static_cast<const bf16*>(xb),
                       static_cast<const bf16*>(w_ih),
                       static_cast<const float*>(bias),
                       static_cast<const bf16*>(w_hh),
                       static_cast<bf16*>(ys_f), static_cast<bf16*>(ys_b),
                       T_, B, Fa, Fb, H, seq_out,
                       static_cast<bf16*>(workspace), s);
  }
  return cudaErrorInvalidValue;
}

const char* dsp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
