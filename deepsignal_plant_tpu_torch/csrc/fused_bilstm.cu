// Fused bidirectional LSTM layer, time-major, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel deepsignal_plant_tpu/ops/pallas_fused.py
// ::_fused_kernel (reached through _layer_fused_impl's pallas_call): one
// whole layer, both directions, input projection included (one launch of
// the bfloat16 or the float32 in-loop kernel, or the float32 projection
// kernel and a recurrence kernel of lstm_recurrence.cu):
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
// order, so the time loop lives inside the block: a block owns BB batch
// rows of one direction for all T steps. Every thread computes all four
// gate pre-activations (columns j, H+j, 2H+j, 3H+j) of the hidden units it
// owns, so the cell update needs no exchange between threads; c stays in
// registers (f32) for the whole sequence; h_{t-1} is exchanged through
// shared memory. The ragged batch edge is masked in the kernel (rows >= B
// read zeros and store nothing); no padding on the host.
//
// What bounds it. Per step and direction the layer is a (BB x (F+H)) by
// ((F+H) x 4H) product, and T=13 steps run in sequence. At the main
// path's comb layers (F=512, H=256, B=4096) a layer is 2*2*T*B*(F+H)*4H =
// 168 GFLOP against ~0.1 GB of compulsory traffic: bound by operations
// (0.17 ms at the bf16 tensor-core peak), not by bytes (0.03 ms).
//
// Three kernels:
//
// bfloat16 (the main path): tensor cores (mma.sync) over weights packed
//   once per model; every block re-reads its direction's packed weights
//   from L2 at every step (below).
// float32, for exact-parity runs, two routes (ops/fused_lstm.py picks):
// - the projection kernel (below): the input projection of all T steps
//   as one 3xTF32 wgmma product into K2's xproj, after which
//   lstm_recurrence.cu's float32 recurrence kernels store h as this file's
//   kernels do. At a comb layer the in-loop design re-read [W_ih; W_hh]
//   (3 MB a direction) from L2 at every step for every 16 rows, ~20 GB a
//   layer at B = 4096; out of the loop the projection runs at the tensor
//   cores' rate, and only W_hh stays in the loop, resident on clusters.
// - the in-loop kernel: CUDA-core FMAs, the projection inside the time
//   loop, for inputs narrower than one K slab of the projection (the
//   branches' 7 and 16 features, whose xproj would be 32-73 times their
//   bytes) at batches that fill the card. block = (round_up(H, 32),
//   max(1, 256 / that)) threads; thread (j, y) owns unit j for RB = 16
//   rows; x_t and h_{t-1} are staged as f32, transposed ([k][row]) so one
//   16-byte load feeds four rows; two __syncthreads() per step order the
//   h exchange; the weights are read from global memory.

#include "dsp_common.cuh"

using namespace dsp;

namespace {

// ---------------------------------------------------------------------------
// float32, the in-loop kernel: CUDA-core FMAs

constexpr int kRowsPerThread = 16;      // RB: rows of one thread
constexpr int kMaxBlockThreads = 512;   // H <= 512
constexpr int kTargetThreads = 256;

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
// float32 route: the input projection on the tensor cores in 3xTF32
//
//   xproj[s, d, b, :] = bias[d] + sum_i x_i[t_d(s), b, :] @ W_ih[d][rows_i]
//   t_0(s) = s, t_1(s) = T-1-s
//
// K2's input contract, (T, 2, B, 4H) f32 with the bias in it and direction
// 1 time-flipped (the flip is the epilogue's row index), over which
// lstm_recurrence.cu's dsp_lstm_recurrence_fwd_k1 runs the recurrence.
// Per direction one product of M = T*B rows, N = 4H, K = Fa + Fb, read
// from the one or two row-split inputs as they are: K slabs [0, Kpa) come
// from xa, [Kpa, Kp) from xb (Kpa = round_up(Fa, 32), Kp = Kpa +
// round_up(Fb, 32)), and the weights are packed once per model to match
// (ops/fused_lstm.py::pack_proj_weights): K-major (2, 4H, Kp), each
// input's rows zero-padded to the slab, already split into tf32 hi and
// lo planes, so only x is split here, once per element as it is staged.
//
// A block computes a kPjM x kPjN tile (rows x gate columns of one
// direction) as two warpgroups of 64 rows, each product one wgmma
// m64n128k8 from shared memory: three a k8 step (3xTF32: lo*hi + hi*lo +
// hi*hi into f32, lo*lo dropped). Shared memory holds two buffers of
// four planes (x hi, x lo, W hi, W lo), each a 128 x 32 tile in the
// 128-byte swizzled layout wgmma reads. While slab k's wgmmas run, slab
// k+1 is staged into the other buffer: the weight planes by cp.async, x
// read into registers, split and stored. (A ring of three slabs that
// keeps one group of wgmmas in flight across the barrier, and A split in
// registers for the register-operand wgmma, were no faster on the H100.)
// x widths that are not a multiple of 4 floats (the seq branch's 7) or
// bases off 16 bytes are read by plain loads; the ragged M edge and the
// K padding read zeros. Grid (2 * ceil(4H / kPjN), ceil(M / kPjM)): the
// blocks that share one x tile run next to each other, so x is read from
// device memory about once.
//
// What bounds it: at a comb layer (M = 53,248 at B = 4096, N = 1,024, K
// = 512) 2 x 56 GFLOP of f32 products, 3 x that in TF32 (0.68 ms at 495
// TFLOP/s), against 0.11 GB of x, 8 MB of weights and 0.44 GB of xproj
// written (0.16 ms at 3.35 TB/s): operations bind. mma.sync m16n8k8 ran
// the same products slower on the H100 (PERF.md).

constexpr int kPjM = 128;                // rows of a block tile
constexpr int kPjN = 128;                // gate columns of a block tile
constexpr int kPjK = 32;                 // K slab: one 128-byte row
constexpr int kPjThreads = 256;          // two warpgroups
constexpr int kPgTile = kPjM * kPjK;     // floats of one plane tile
static_assert(kPjK == kSwK, "a K slab is one swizzled 128-byte row");

__global__ void __launch_bounds__(kPjThreads, 1)
proj_f32_kernel(const float* __restrict__ xa, const float* __restrict__ xb,
                const float* __restrict__ w_hi,
                const float* __restrict__ w_lo,
                const float* __restrict__ bias, float* __restrict__ xproj,
                int T_, int B, int Fa, int Fb, int H, int Kpa, int Kp,
                int vec_a, int vec_b) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* const sm = sw_align(smem_raw);     // swizzle atoms on 1,024 bytes
  const int G4 = 4 * H;
  const int ntn = (G4 + kPjN - 1) / kPjN;
  const int d = blockIdx.x / ntn;
  const int n0 = (blockIdx.x - d * ntn) * kPjN;
  const int m0 = blockIdx.y * kPjM;
  const int M = T_ * B;
  const int nk = Kp / kPjK;
  const float* whi = w_hi + (size_t)d * G4 * Kp;
  const float* wlo = w_lo + (size_t)d * G4 * Kp;
  const int wg = threadIdx.x / 128;
  const int warp4 = (threadIdx.x / 32) & 3;
  const int lane = threadIdx.x % 32;
  const int gq = lane >> 2, q = lane & 3;
  // plane p (0 x hi, 1 x lo, 2 W hi, 3 W lo) of buffer b
  auto plane = [&](int b, int p) { return sm + (b * 4 + p) * kPgTile; };

  // 16-byte chunk c of a plane tile: row c >> 3, k chunk c & 7, so eight
  // neighbouring threads read one row's 128 bytes and fill one shared
  // row
  float4 xr[4];
  auto load_x = [&](int kt) {
    const int k0 = kt * kPjK;
    const bool from_a = k0 < Kpa;
    const float* x = from_a ? xa : xb;
    const int F = from_a ? Fa : Fb;
    const int c0 = from_a ? k0 : k0 - Kpa;
    const bool vec = from_a ? vec_a : vec_b;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = threadIdx.x + i * kPjThreads;
      const int m = m0 + (c >> 3);
      const int col = c0 + (c & 7) * 4;
      const float* src = x + (size_t)m * F + col;
      if (vec) {
        xr[i] = m < M && col < F ? *reinterpret_cast<const float4*>(src)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        const bool ok = m < M;
        xr[i] = make_float4(ok && col < F ? src[0] : 0.f,
                            ok && col + 1 < F ? src[1] : 0.f,
                            ok && col + 2 < F ? src[2] : 0.f,
                            ok && col + 3 < F ? src[3] : 0.f);
      }
    }
  };
  auto store_x = [&](int b) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = threadIdx.x + i * kPjThreads;
      const int off = sw_off(c >> 3, (c & 7) * 4);
      uint4 hi, lo;
      split_tf32(xr[i].x, hi.x, lo.x);
      split_tf32(xr[i].y, hi.y, lo.y);
      split_tf32(xr[i].z, hi.z, lo.z);
      split_tf32(xr[i].w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(plane(b, 0) + off) = hi;
      *reinterpret_cast<uint4*>(plane(b, 1) + off) = lo;
    }
  };
  auto stage_w = [&](int kt, int b) {
    for (int i = threadIdx.x; i < 2 * kPgTile / 4; i += kPjThreads) {
      const int lo = i >= kPgTile / 4;
      const int c = lo ? i - kPgTile / 4 : i;
      const int r = c >> 3;
      const int k = (c & 7) * 4;
      const int n = n0 + r;
      const bool ok = n < G4;
      cp_async16(plane(b, 2 + lo) + sw_off(r, k),
                 (lo ? wlo : whi) + (size_t)(ok ? n : 0) * Kp + kt * kPjK + k,
                 ok);
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  load_x(0);
  stage_w(0, 0);
  cp_async_commit();
  store_x(0);
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int b = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      load_x(kt + 1);
      stage_w(kt + 1, b ^ 1);
    }
    cp_async_commit();
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kPjK / 8; ++j) {
      // k8 step j: 32 bytes into each 128-byte row (the swizzle applies
      // to the address the descriptor forms)
      const int ao = wg * 64 * kPjK + j * 8, bo = j * 8;
      const uint64_t ah = gmma_desc(plane(b, 0) + ao);
      const uint64_t al = gmma_desc(plane(b, 1) + ao);
      const uint64_t bh = gmma_desc(plane(b, 2) + bo);
      const uint64_t bl = gmma_desc(plane(b, 3) + bo);
      wgmma_tf32_m64n128(acc, al, bh);
      wgmma_tf32_m64n128(acc, ah, bl);
      wgmma_tf32_m64n128(acc, ah, bh);
    }
    wgmma_commit();
    if (more) store_x(b ^ 1);               // while the wgmmas run
    wgmma_wait<0>();
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
  }

  // accumulator i: rows gq + 8*((i >> 1) & 1) of the warp's 16, column
  // 8*(i >> 2) + 2q + (i & 1)
  const float* bd = bias + (size_t)d * G4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + wg * 64 + warp4 * 16 + gq + half * 8;
    if (m >= M) continue;
    const int t = m / B;
    const int bb = m - t * B;
    const int s = d ? T_ - 1 - t : t;
    float* orow = xproj + (((size_t)s * 2 + d) * B + bb) * G4;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * q;
      if (n < G4)
        *reinterpret_cast<float2*>(orow + n) =
            make_float2(acc[4 * j + 2 * half] + bd[n],
                        acc[4 * j + 2 * half + 1] + bd[n + 1]);
    }
  }
}

// K of the projection's packed weights: each input's width rounded up to
// the K slab (ops/fused_lstm.py::proj_k)
inline int proj_k(int F) { return (F + kPjK - 1) / kPjK * kPjK; }

cudaError_t launch_proj_f32(const float* xa, const float* xb,
                            const float* w_hi, const float* w_lo,
                            const float* bias, float* xproj, int T_, int B,
                            int Fa, int Fb, int H, cudaStream_t stream) {
  const int Kpa = proj_k(Fa);
  const int Kp = Kpa + proj_k(Fb);
  const long long mtiles = ((long long)T_ * B + kPjM - 1) / kPjM;
  if (mtiles > 65535) return cudaErrorInvalidValue;
  // two buffers of four planes, and room to align them to 1,024 bytes
  const size_t smem = (size_t)2 * 4 * kPgTile * sizeof(float) + 1024;
  const cudaError_t err = set_smem((const void*)proj_f32_kernel, smem);
  if (err != cudaSuccess) return err;
  auto vec = [](const float* x, int F) {
    return reinterpret_cast<uintptr_t>(x) % 16 == 0 && F % 4 == 0;
  };
  const dim3 grid(2 * ((4 * H + kPjN - 1) / kPjN), (unsigned)mtiles);
  proj_f32_kernel<<<grid, kPjThreads, smem, stream>>>(
      xa, xb, w_hi, w_lo, bias, xproj, T_, B, Fa, Fb, H, Kpa, Kp,
      vec(xa, Fa), Fb > 0 && vec(xb, Fb));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16) over the packed weights wt
// (2, 4H, Kp): wt[d][n][k] = [W_ih[d]; W_hh[d]][k][n] for k < F + H, zero
// up to Kp = round_up(F + H, 32). The wrapper packs them once per model
// (ops/fused_lstm.py::pack_weights), so one 16-byte load gives a thread
// its fragments of two k16 steps (the k index is permuted alike in A and
// B, which leaves the sum unchanged).
//
// Grid (ceil(B / 32), 2 directions): a block owns BB = 32 rows (MT = 2
// m16 tiles) of one direction for all T steps and reads its direction's
// packed weights from L2 at every step (1.5 MB per block per step at a
// comb layer). The latency of each warp's chain of those L2 loads, step
// after step, rather than the tensor cores, sets its time (PERF.md).
//
// A warp's accumulator fragments are four 16x8 tiles per m16 tile, one per
// gate, over the same 8 hidden units, so a thread holds i, f, g and o of
// the same (row, unit) pairs: the cell update needs no exchange and c
// stays in f32 registers. The A operand, [x_t | h_{t-1}] of the block's
// rows in bf16, is double-buffered in shared memory: step s reads one
// buffer while h_s and x_{s+1} go into the other.

constexpr int kMmaTiles = 2;                  // MT: m16 tiles of a block
constexpr int kMmaRows = 16 * kMmaTiles;      // BB
constexpr int kMmaWarps = 8;

// K of the packed weights: F + H rounded up to the k32 step
inline int padded_k(int F, int H) { return (F + H + 31) / 32 * 32; }

// x_t of the block's rows into columns [0, F) of an A buffer; rows past
// the batch edge read zeros. vec (widths a multiple of 8, 16-byte aligned
// bases): 16-byte cp.async, completed by the caller's cp_async_wait; else
// plain loads and stores.
__device__ __forceinline__ void stage_x(bf16* __restrict__ buf,
                                        const bf16* __restrict__ xa,
                                        const bf16* __restrict__ xb, int t,
                                        int B, int b0, int Fa, int Fb, int Ks,
                                        bool vec) {
  const int F = Fa + Fb;
  if (vec) {
    const int F8 = F / 8;
    for (int i = threadIdx.x; i < kMmaRows * F8; i += blockDim.x) {
      const int r = i / F8;
      const int k = (i - r * F8) * 8;
      const int row = b0 + r;
      const bool ok = row < B;
      const bf16* src = xa;
      if (ok)
        src = k < Fa ? xa + ((size_t)t * B + row) * Fa + k
                     : xb + ((size_t)t * B + row) * Fb + (k - Fa);
      cp_async16(buf + r * Ks + k, src, ok);
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
                         int Ks, int seq_out, int vec) {
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
  stage_x(buf0, xa, xb, d == 0 ? 0 : T_ - 1, B, b0, Fa, Fb, Ks, vec != 0);
  cp_async_commit();
  cp_async_wait<0>();
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
      stage_x(nxt, xa, xb, d == 0 ? s + 1 : T_ - 2 - s, B, b0, Fa, Fb, Ks,
              vec != 0);
    cp_async_commit();
    const bool store = seq_out || s == T_ - 1;
    const int t_out = seq_out ? t : 0;

#pragma unroll
    for (int gi = 0; gi < GPW; ++gi) {
      const int grp = warp + gi * nwarps;
      if (grp >= ngroups) break;            // the same for the whole warp
      const int j0 = grp * 8;
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
      // B fragments: this thread loads column gate*H + j0 + gq
      const bool bvalid = j0 + gq < H;
      const bf16* wrow = w + (size_t)(j0 + gq) * Kp + 8 * q;
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
    cp_async_wait<0>();
    __syncthreads();                        // h_s and x_{s+1} are in nxt
  }
}

template <int GPW>
cudaError_t launch_bf16_kernel(const bf16* xa, const bf16* xb, const bf16* wt,
                               const float* bias, bf16* ys_f, bf16* ys_b,
                               int T_, int B, int Fa, int Fb, int H, int Kp,
                               int seq_out, int vec, cudaStream_t stream) {
  const int Ks = smem_stride(Kp);
  const size_t smem = (size_t)2 * kMmaRows * Ks * sizeof(bf16);
  auto kernel = fused_bilstm_bf16_kernel<GPW>;
  const cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  const int nwarps = ((H + 7) / 8 + GPW - 1) / GPW;
  const dim3 grid((B + kMmaRows - 1) / kMmaRows, 2);
  kernel<<<grid, nwarps * 32, smem, stream>>>(xa, xb, wt, bias, ys_f, ys_b,
                                              T_, B, Fa, Fb, H, Kp, Ks,
                                              seq_out, vec);
  return cudaGetLastError();
}

// 16-byte copies of x need widths a multiple of 8 and aligned bases
inline bool x_vec(const void* xa, const void* xb, int Fa, int Fb) {
  return reinterpret_cast<uintptr_t>(xa) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(xb) % 16 == 0 && Fa % 8 == 0 &&
         Fb % 8 == 0;
}

cudaError_t launch_bf16(const bf16* xa, const bf16* xb, const bf16* wt,
                        const float* bias, bf16* ys_f, bf16* ys_b, int T_,
                        int B, int Fa, int Fb, int H, int seq_out,
                        cudaStream_t stream) {
  const int Kp = padded_k(Fa + Fb, H);
  const int vec = x_vec(xa, xb, Fa, Fb);
  // the fewest unit groups per warp that keep a block at <= 8 warps
  const int ngroups = (H + 7) / 8;
  if (ngroups <= kMmaWarps)
    return launch_bf16_kernel<1>(xa, xb, wt, bias, ys_f, ys_b, T_, B, Fa, Fb,
                                 H, Kp, seq_out, vec, stream);
  if (ngroups <= 2 * kMmaWarps)
    return launch_bf16_kernel<2>(xa, xb, wt, bias, ys_f, ys_b, T_, B, Fa, Fb,
                                 H, Kp, seq_out, vec, stream);
  if (ngroups <= 4 * kMmaWarps)
    return launch_bf16_kernel<4>(xa, xb, wt, bias, ys_f, ys_b, T_, B, Fa, Fb,
                                 H, Kp, seq_out, vec, stream);
  return launch_bf16_kernel<8>(xa, xb, wt, bias, ys_f, ys_b, T_, B, Fa, Fb, H,
                               Kp, seq_out, vec, stream);
}

}  // namespace

extern "C" {

// float32, the in-loop kernel: x* (T, B, F*) row-major; w_ih (2, Fa+Fb,
// 4H); w_hh (2, H, 4H); bias (2, 4H); ys_f/ys_b (T or 1, B, H). Runs on
// `stream`, allocates nothing, returns the launch's error code.
cudaError_t dsp_fused_bilstm_f32(const void* xa, const void* xb,
                                 const void* w_ih, const void* bias,
                                 const void* w_hh, void* ys_f, void* ys_b,
                                 int T_, int B, int Fa, int Fb, int H,
                                 int seq_out, void* stream) {
  if (T_ < 1 || B < 1 || Fa < 1 || Fb < 0 || H < 1 ||
      H > kMaxBlockThreads || (Fb > 0 && xb == nullptr))
    return cudaErrorInvalidValue;
  return launch_f32(static_cast<const float*>(xa),
                    static_cast<const float*>(xb),
                    static_cast<const float*>(w_ih),
                    static_cast<const float*>(bias),
                    static_cast<const float*>(w_hh),
                    static_cast<float*>(ys_f), static_cast<float*>(ys_b), T_,
                    B, Fa, Fb, H, seq_out, static_cast<cudaStream_t>(stream));
}

// The float32 route's input projection: x* (T, B, F*) float32; w_hi and
// w_lo (2, 4H, Kp) the tf32 hi and lo planes of W_ih packed as described
// above (Kp = round_up(Fa, 32) + round_up(Fb, 32)), 16-byte aligned; bias
// (2, 4H) f32 -> xproj (T, 2, B, 4H) f32 (T*B <= 65,535 * 128 rows). Runs
// on `stream`, allocates nothing, returns the launch's error code.
cudaError_t dsp_fused_bilstm_proj_f32(const void* xa, const void* xb,
                                      const void* w_hi, const void* w_lo,
                                      const void* bias, void* xproj, int T_,
                                      int B, int Fa, int Fb, int H,
                                      void* stream) {
  if (T_ < 1 || B < 1 || Fa < 1 || Fb < 0 || H < 1 ||
      H > kMaxBlockThreads || (Fb > 0 && xb == nullptr) ||
      reinterpret_cast<uintptr_t>(w_hi) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w_lo) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(xproj) % 8 != 0)
    return cudaErrorInvalidValue;
  return launch_proj_f32(static_cast<const float*>(xa),
                         static_cast<const float*>(xb),
                         static_cast<const float*>(w_hi),
                         static_cast<const float*>(w_lo),
                         static_cast<const float*>(bias),
                         static_cast<float*>(xproj), T_, B, Fa, Fb, H,
                         static_cast<cudaStream_t>(stream));
}

// bfloat16: x* (T, B, F*) and ys_f/ys_b (T or 1, B, H) bf16; wt (2, 4H,
// round_up(Fa+Fb+H, 32)) bf16, the packed weights described above,
// 16-byte aligned; bias (2, 4H) f32. Runs on `stream`, allocates nothing,
// returns the launch's error code.
cudaError_t dsp_fused_bilstm_bf16(const void* xa, const void* xb,
                                  const void* wt, const void* bias,
                                  void* ys_f, void* ys_b, int T_, int B,
                                  int Fa, int Fb, int H, int seq_out,
                                  void* stream) {
  if (T_ < 1 || B < 1 || Fa < 1 || Fb < 0 || H < 1 ||
      H > kMaxBlockThreads || (Fb > 0 && xb == nullptr) ||
      reinterpret_cast<uintptr_t>(wt) % 16 != 0)
    return cudaErrorInvalidValue;
  return launch_bf16(static_cast<const bf16*>(xa),
                     static_cast<const bf16*>(xb),
                     static_cast<const bf16*>(wt),
                     static_cast<const float*>(bias),
                     static_cast<bf16*>(ys_f), static_cast<bf16*>(ys_b), T_,
                     B, Fa, Fb, H, seq_out, static_cast<cudaStream_t>(stream));
}

const char* dsp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
