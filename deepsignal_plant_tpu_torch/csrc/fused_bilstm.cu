// Fused bidirectional LSTM layer, time-major, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel deepsignal_plant_tpu/ops/pallas_fused.py
// ::_fused_kernel (reached through _layer_fused_impl's pallas_call): one
// whole layer, both directions, input projection included (one launch of
// a bfloat16 kernel or of the float32 narrow or in-loop kernel, or the
// float32 projection kernel and a recurrence kernel of
// lstm_recurrence.cu):
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
// Five kernels:
//
// bfloat16 (the main path), two kernels over weights packed once per
//   model (ops/fused_lstm.py::k1_bf16_plan picks):
// - the wgmma kernel (below): 64-row blocks, products on wgmma, the
//   weights resident in shared memory for the launch (inputs of at most
//   32 features at H <= 128: the branches) or streamed by TMA bulk copies
//   into a ring of tiles for each consumer warpgroup, wherever it fits
//   (H <= 256 and its shared memory);
// - the mma.sync kernel (below): 32-row blocks that re-read their
//   direction's packed weights from L2 at every step; it takes the
//   shapes the wgmma kernel does not fit.
// float32, for exact-parity runs, three routes (ops/fused_lstm.py::
// f32_route picks one a layer):
// - the narrow kernel (below): the layers whose input is narrower than
//   the projection's K slab of 32 (the seq and signal branches' 7 and 16
//   features; it takes F <= 16) at H = 128 and 256, one launch a layer,
//   the projection inside the time loop, on the tensor cores in 3xTF32
//   with the weights resident across a thread-block cluster:
//   - A cluster of C blocks owns a tile of `rows` batch rows of one
//     direction for all T steps (grid (C * ceil(B / rows), 2)); block r
//     owns U = H / C hidden units (64 at H = 128, C = 2; 32 at H = 256,
//     C = 8) and all four gates of each, so the cell update stays in the
//     block (and thread) that owns c. Before step 0 it copies its slice
//     of [W_ih; W_hh], transposed (4U rows of Kx + H, Kx = 8 or 16), into
//     shared memory by cp.async, where it stays for the launch. The
//     weights are packed once per model (ops/fused_lstm.py::
//     pack_narrow_weights): K-major, W_ih's rows zero-padded to Kx, then
//     W_hh's; rows in (8-unit group, gate, unit) order, so a block's
//     slice is contiguous and a warp's four gate tiles of a group are 32
//     neighbouring rows.
//   - Each step is one product, [x_t | h_{t-1}] (rows x (Kx + H)) by the
//     slice ((Kx + H) x 4U), on mma.sync m16n8k8 in 3xTF32 (lo*hi + hi*lo
//     + hi*hi, lo*lo dropped), as the float32 cluster kernels of
//     lstm_recurrence.cu run theirs. Both operands' fragments load by
//     ldmatrix (rows of Kx + H + 4 floats: conflict-free) and are split
//     into tf32 hi and lo in registers (split_tf32's integer ops) at
//     every step: split planes do not fit, neither W's (twice the slice,
//     2 x 151 KB at H = 128) nor h's (the A buffer twice over, were each
//     block to split the h it produces once for the cluster). 16 warps:
//     warp w owns 8-unit group w % (U / 8) and every 16 / (U / 8)-th m16
//     tile from w / (U / 8) on; its accumulators hold i, f, g and o of the
//     same (row, unit) pairs. The cell update takes sigmoid and tanh from
//     __expf and __fdividef (f32, a few ulp; with expf, tanhf and IEEE
//     divisions the layers were slower on the H100).
//   - The A operand, [x_t | h_{t-1}] of the tile's rows, is one buffer
//     in every block. h_t crosses the cluster through distributed shared
//     memory: each block writes its units of h_t into every block's
//     buffer between two cluster barriers (the first's arrive after the
//     product, its wait after the cell update, before the writes; the
//     second after them), then x_{t+1}, read into registers during the
//     cell update.
//   - The plan (ops/fused_lstm.py::narrow_plan, on the card's occupancy
//     query dsp_fused_bilstm_narrow_clusters) picks the row tile: at
//     call_mods' 4096-row tiles 128 rows, 32 tiles x 2 directions x 2
//     blocks = 128 blocks, one wave on the H100's 132 SMs. Shared memory
//     at that tile (signal, F = 16, H = 128): the slice 256 x 148 x 4 =
//     151,552 bytes and the A buffer 128 x 148 x 4 = 75,776, 227,328 of a
//     block's 232,448.
//   What bounds it: a signal layer at 4096 rows is 2 * 2 * T * B * (F +
//   H) * 4H = 15.7 GFLOP of f32 products, 47 GFLOP in 3xTF32 (0.095 ms
//   at 495 TFLOP/s, the FFMA peak's 0.234 ms beside it), against 7 MB of
//   compulsory bytes (2 us): operations bind. On the H100 mma.sync does
//   not reach the wgmma rate, the splits take issue slots beside the
//   products, and each step ends in the cell update and two cluster
//   barriers (PERF.md has the times).
// - the projection kernel (below): the input projection of all T steps
//   as one 3xTF32 wgmma product into K2's xproj, after which
//   lstm_recurrence.cu's float32 recurrence kernels store h as this file's
//   kernels do. At a comb layer the in-loop design re-read [W_ih; W_hh]
//   (3 MB a direction) from L2 at every step for every 16 rows, ~20 GB a
//   layer at B = 4096; out of the loop the projection runs at the tensor
//   cores' rate, and only W_hh stays in the loop (streamed by TMA to
//   64-row blocks in lstm_recurrence.cu's k1_rec kernel at call_mods'
//   4096-row tiles, resident on clusters in K2's kernel elsewhere).
// - the in-loop kernel: CUDA-core FMAs, the projection inside the time
//   loop, for inputs narrower than one K slab of the projection (whose
//   xproj would be 4H / F times their bytes) that the narrow kernel has no
//   plan for (H other than 128 and 256), at batches that fill the card.
//   The narrow kernel replaced it at the branches. block = (round_up(H, 32),
//   max(1, 256 / that)) threads; thread (j, y) owns unit j for RB = 16
//   rows; x_t and h_{t-1} are staged as f32, transposed ([k][row]) so one
//   16-byte load feeds four rows; two __syncthreads() per step order the
//   h exchange; the weights are read from global memory.

#include <cooperative_groups.h>

#include "dsp_common.cuh"

using namespace dsp;
namespace cg = cooperative_groups;

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
// float32, the narrow kernel: 3xTF32 mma.sync over [W_ih; W_hh] slices
// resident across a thread-block cluster (described in the header)

constexpr int kNwWarps = 16;
constexpr int kNwThreads = kNwWarps * 32;
constexpr int kNwMaxF = 16;              // the widest input it takes

// x width of the packed weights (ops/fused_lstm.py::narrow_kx): F
// rounded up to 8 or 16
inline int narrow_kx(int F) { return F <= 8 ? 8 : 16; }

// shared-memory bytes of a block: its weight slice, transposed (4U rows
// of Kx + H + 4 floats), and the A buffer (rows of the same width); the
// same formula as ops/fused_lstm.py::narrow_smem
inline size_t narrow_smem(int Kx, int H, int U, int rows) {
  return (size_t)(Kx + H + 4) * (4 * U + rows) * sizeof(float);
}

// v to the same shared-memory offset as `addr` (this block's) in block
// `rank` of the cluster
__device__ __forceinline__ void st_cluster_f2(uint32_t addr, uint32_t rank,
                                              float2 v) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "st.shared::cluster.v2.f32 [ra], {%2, %3};\n}\n"
      :: "r"(addr), "r"(rank), "f"(v.x), "f"(v.y) : "memory");
}

// four 8 x 4 tiles of 32-bit values (rows of 16 bytes at the addresses
// lanes 8i..8i+7 give for tile i): thread t gets element (t / 4, t % 4)
// of each, the fragment layout of mma.m16n8k8's tf32 operands
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void split4(const uint32_t (&v)[4],
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(v[i]), hi[i], lo[i]);
}

// MT: m16 tiles of the row tile (rows = 16 MT); U: hidden units of a
// block; C: blocks of a cluster (H = U C); KX: x columns (Fa + Fb <= KX).
// ys_f/ys_b (T or 1, B, H).
template <int MT, int U, int C, int KX>
__global__ void __launch_bounds__(kNwThreads, 1)
fused_bilstm_narrow_f32_kernel(const float* __restrict__ xa,
                               const float* __restrict__ xb,
                               const float* __restrict__ wp,
                               const float* __restrict__ bias,
                               float* __restrict__ ys_f,
                               float* __restrict__ ys_b, int T_, int B,
                               int Fa, int Fb, int seq_out) {
  constexpr int H = U * C;
  constexpr int K = KX + H;
  constexpr int L = K + 4;                  // rows of W^T and of A
  constexpr int BB = 16 * MT;
  constexpr int G = U / 8;                  // 8-unit groups of a block
  constexpr int WPG = kNwWarps / G;         // warps of a group
  constexpr int MW = (MT + WPG - 1) / WPG;  // m16 tiles of a warp, at most
  constexpr bool EVEN = MT % WPG == 0;      // every warp has MW of them
  constexpr int N = 4 * U;                  // gate columns of the block
  constexpr int NX = (BB * KX + kNwThreads - 1) / kNwThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int d = blockIdx.y;
  const int F = Fa + Fb;
  const int u0 = rank * U;
  const int b0 = ((int)blockIdx.x / C) * BB;
  float* const wsm = reinterpret_cast<float*>(smem_raw);  // N x L: W^T
  float* const abuf = wsm + N * L;                         // BB x L: A
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q = lane & 3;
  const int grp = warp % G;                 // the warp's 8-unit group
  const int mt0 = warp / G;                 // its m16 tiles mt0 + WPG i
  const int jl = grp * 8 + 2 * q;           // this thread's units jl, jl+1
  auto has = [&](int mw) { return EVEN || mt0 + WPG * mw < MT; };

  // the slice: rows [rank N, rank N + N) of wp[d] (packed once per
  // model, K-major), by 16-byte cp.async
  const float* wd = wp + ((size_t)d * 4 * H + rank * N) * K;
  for (int i = threadIdx.x; i < N * (K / 4); i += kNwThreads) {
    const int n = i / (K / 4), k = (i % (K / 4)) * 4;
    cp_async16(wsm + n * L + k, wd + (size_t)n * K + k, true);
  }
  cp_async_commit();

  // x_t of the tile's rows into registers: value j is A element (r, k)
  // of i = threadIdx.x + j * kNwThreads, r = i / KX, k = i % KX; zeros
  // past F and past the batch edge
  float xr[NX];
  auto load_x = [&](int s) {
    const int t = d == 0 ? s : T_ - 1 - s;
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      const int i = threadIdx.x + j * kNwThreads;
      const int r = i / KX, k = i % KX;
      const int row = b0 + r;
      float v = 0.f;
      if (r < BB && row < B && k < F)
        v = k < Fa ? xa[((size_t)t * B + row) * Fa + k]
                   : xb[((size_t)t * B + row) * Fb + (k - Fa)];
      xr[j] = v;
    }
  };
  auto store_x = [&]() {
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      const int i = threadIdx.x + j * kNwThreads;
      const int r = i / KX, k = i % KX;
      if (r < BB) abuf[r * L + k] = xr[j];
    }
  };

  // h_{-1} = 0, x_0 in place
  for (int i = threadIdx.x; i < BB * L; i += kNwThreads) abuf[i] = 0.f;
  load_x(0);
  __syncthreads();
  store_x();
  // the row addresses this lane gives ldmatrix: A, row lane % 16 of an
  // m16 tile, k + 4 (lane / 16); W^T, row lane % 8 of gate 2 gp + lane /
  // 16 of its group, k + 4 ((lane / 8) % 2)
  const uint32_t a_addr = static_cast<uint32_t>(__cvta_generic_to_shared(
      abuf + (mt0 * 16 + (lane & 15)) * L + 4 * (lane >> 4)));
  const uint32_t w_addr = static_cast<uint32_t>(__cvta_generic_to_shared(
      wsm + (grp * 32 + (lane >> 4) * 8 + (lane & 7)) * L +
      4 * ((lane >> 3) & 1)));
  const float* bd = bias + d * 4 * H + u0 + jl;
  cp_async_wait<0>();
  cluster_arrive();                         // every peer runs, W is in place
  cluster_wait();

  float c[MW][4];
#pragma unroll
  for (int mw = 0; mw < MW; ++mw)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[mw][e] = 0.f;

  for (int s = 0; s < T_; ++s) {
    const bool last = s + 1 == T_;
    const int t = d == 0 ? s : T_ - 1 - s;
    float acc[MW][4][4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float2 bv = *reinterpret_cast<const float2*>(bd + g * H);
#pragma unroll
      for (int mw = 0; mw < MW; ++mw) {
        acc[mw][g][0] = acc[mw][g][2] = bv.x;
        acc[mw][g][1] = acc[mw][g][3] = bv.y;
      }
    }

    // pre = b + [x_t | h_{t-1}] @ [W_ih; W_hh], the block's columns
#pragma unroll 2
    for (int kk = 0; kk < K; kk += 8) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int gp = 0; gp < 2; ++gp) {      // gates 2 gp, 2 gp + 1
        uint32_t v[4], hi[4], lo[4];
        ldsm_x4(v, w_addr + (gp * 16 * L + kk) * 4);
        split4(v, hi, lo);
        bh[2 * gp][0] = hi[0]; bh[2 * gp][1] = hi[1];
        bh[2 * gp + 1][0] = hi[2]; bh[2 * gp + 1][1] = hi[3];
        bl[2 * gp][0] = lo[0]; bl[2 * gp][1] = lo[1];
        bl[2 * gp + 1][0] = lo[2]; bl[2 * gp + 1][1] = lo[3];
      }
#pragma unroll
      for (int mw = 0; mw < MW; ++mw) {
        if (has(mw)) {                      // the same for the whole warp
          uint32_t v[4], ah[4], al[4];
          ldsm_x4(v, a_addr + (WPG * mw * 16 * L + kk) * 4);
          // tiles: rows 0-7 and 8-15 at k, then at k + 4
          split4(v, ah, al);
#pragma unroll
          for (int g = 0; g < 4; ++g)
            mma_3xtf32(acc[mw][g], ah, al, bh[g], bl[g]);
        }
      }
    }
    if (!last) {
      cluster_arrive();                     // this block read A
      load_x(s + 1);                        // in flight during the update
    }

    const bool store = seq_out || last;
    const int t_out = seq_out ? t : 0;
    float* ys = d == 0 ? ys_f : ys_b;
    float2 hv[MW][2];
#pragma unroll
    for (int mw = 0; mw < MW; ++mw) {
      if (!has(mw)) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float h[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int e = 2 * half + k;
          const float ig = sigmoid_fast(acc[mw][0][e]);
          const float fg = sigmoid_fast(acc[mw][1][e]);
          const float gg = tanh_fast(acc[mw][2][e]);
          const float og = sigmoid_fast(acc[mw][3][e]);
          c[mw][e] = fg * c[mw][e] + ig * gg;
          h[k] = og * tanh_fast(c[mw][e]);
        }
        hv[mw][half] = make_float2(h[0], h[1]);
        const int row = b0 + (mt0 + WPG * mw) * 16 + (lane >> 2) + half * 8;
        if (store && row < B)
          *reinterpret_cast<float2*>(ys + ((size_t)t_out * B + row) * H +
                                     u0 + jl) = hv[mw][half];
      }
    }
    if (last) break;                        // h_{T-1} feeds no product
    cluster_wait();                         // every peer read its A
#pragma unroll
    for (int mw = 0; mw < MW; ++mw) {
      if (!has(mw)) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(
            abuf + ((mt0 + WPG * mw) * 16 + (lane >> 2) + half * 8) * L +
            KX + u0 + jl));
#pragma unroll
        for (int p = 0; p < C; ++p) st_cluster_f2(a, p, hv[mw][half]);
      }
    }
    store_x();                              // x_{t+1} of this block's rows
    cluster_arrive();                       // h_t is in every block's A
    cluster_wait();
  }
}

// the narrow kernel's designs: (units a block, cluster) = (64, 2) at H =
// 128 and (32, 8) at H = 256; x widths 8 and 16; row tiles of 16 to 128
inline const void* narrow_kernel(int H, int cluster, int Kx, int rows) {
  if (rows % 16 != 0 || !(Kx == 8 || Kx == 16)) return nullptr;
#define DSP_NW2(MT, U, C, KX)                                              \
  (const void*)fused_bilstm_narrow_f32_kernel<MT, U, C, KX>
#define DSP_NW(MT)                                                         \
  if (rows == 16 * MT) {                                                   \
    if (H == 128 && cluster == 2)                                          \
      return Kx == 8 ? DSP_NW2(MT, 64, 2, 8) : DSP_NW2(MT, 64, 2, 16);     \
    if (H == 256 && cluster == 8)                                          \
      return Kx == 8 ? DSP_NW2(MT, 32, 8, 8) : DSP_NW2(MT, 32, 8, 16);     \
  }
  DSP_NW(1) DSP_NW(2) DSP_NW(3) DSP_NW(4)
  DSP_NW(5) DSP_NW(6) DSP_NW(7) DSP_NW(8)
#undef DSP_NW
#undef DSP_NW2
  return nullptr;
}

// the launch configuration of the plan (cluster, rows) over `tiles` row
// tiles: grid (cluster * tiles, 2), cluster (cluster, 1, 1), kNwThreads
// threads; allows the shared memory. Refuses what narrow_plan cannot
// give (no kernel, shared memory past a block's).
inline cudaError_t narrow_config(int F, int H, int cluster, int rows,
                                 int tiles, cudaStream_t stream,
                                 const void** kernel,
                                 cudaLaunchConfig_t* cfg,
                                 cudaLaunchAttribute* attr) {
  if (F < 1 || F > kNwMaxF || tiles < 1) return cudaErrorInvalidValue;
  const int Kx = narrow_kx(F);
  *kernel = narrow_kernel(H, cluster, Kx, rows);
  if (*kernel == nullptr) return cudaErrorInvalidValue;
  const size_t smem = narrow_smem(Kx, H, H / cluster, rows);
  const cudaError_t err = set_smem(*kernel, smem);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster * tiles, 2);
  cfg->blockDim = dim3(kNwThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
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
// bfloat16, the mma.sync kernel (for the shapes the wgmma kernel below
// does not fit): tensor cores (mma.sync m16n8k16) over the packed weights
// wt (2, 4H, Kp): wt[d][n][k] = [W_ih[d]; W_hh[d]][k][n] for k < F + H, zero
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

// ---------------------------------------------------------------------------
// bfloat16 on wgmma: the main path's kernel wherever it fits (H <= 256 and
// its shared memory; ops/fused_lstm.py::k1_bf16_plan picks, the mma.sync
// kernel above takes the rest)
//
// The mma.sync kernel streams its weights through 16-byte loads: every
// 32-row block re-reads its direction's packed [W_ih; W_hh] from L2 at
// every step, ~14 GB of L2 reads a 4096-row tile at the comb layers. This
// kernel feeds wgmma from shared memory, in one of two designs (the
// template's KIND), each a block of 64 rows (one wgmma M tile) of one
// direction for all T steps, grid (ceil(B / 64), 2), 384 threads: two
// consumer warpgroups (warps 0-7) that split the units, and a producer
// warpgroup (warps 8-11) that moves the weights and gives its registers
// to the consumers (setmaxnreg).
//
// - Resident (kWgResident: F <= 32, H <= 128: the seq and signal
//   branches): each block copies its direction's [W_ih; W_hh] (160 KB at
//   H = 128) into shared memory once, by TMA bulk copies, and keeps it
//   for all T steps (ops/fused_lstm.py::pack_weights_resident: per
//   warpgroup and chunk, W_ih's tile, K padded to 32 in the 64-byte
//   swizzle, then W_hh's slabs of 64 in the 128-byte swizzle). x_{t+1}
//   is read into registers during step t (one 16-byte load a thread, or
//   eight 2-byte loads where F is not a multiple of 8, as the seq
//   branch's 7) and stored into the other of two x buffers; h_t goes into
//   the other of two h buffers; one named barrier of the consumers ends
//   a step.
// - Streamed (kWgStreamed: the comb layers, and denoise's H = 256
//   layers): the weights are packed once per model
//   (ops/fused_lstm.py::pack_weights_wgmma) in the order the kernel
//   streams them, per chunk cc and K slab (the h slabs first, then x's),
//   one 128 x 64 tile a warpgroup (16 KB), the 128-byte swizzled image
//   wgmma reads. Each warpgroup has a ring of S (2 or 3) such tiles, kept
//   full by its own producer thread (warp 8 lane 0 for warpgroup 0, warp
//   9 lane 0 for 1) with one TMA bulk copy a tile; its 4 warps release a
//   tile as soon as its products are done (mbarriers). The stream does
//   not depend on h, so the producers run ahead across steps. No
//   cluster: the copies are not multicast (on the H100, a block alone
//   took 9.5 us a step of comb1's 1.5 MB at five 32 KB stages, a pair
//   sharing each copy 14.3 us at any depth). One h buffer: h_t is held
//   in registers (bf16) until every product of step t has read h_{t-1},
//   then stored between two named barriers. (Rings of 4-6 tiles, where
//   they fit, were 1-7% slower than 3 on the H100.) x_{t+1} is staged by
//   cp.async into a second x buffer
//   during step t where one fits beside the rings, else into the one
//   buffer between the two barriers, and awaited before the first x
//   slab.
//
// Both: warpgroup w owns units [w * Hp/2, (w + 1) * Hp/2) (Hp =
// round_up(H, 64)) in NCH = Hp / 64 chunks of 32 units; a chunk is one
// m64n128 accumulator (wgmma m64n128k16, bf16 operands, f32 sums) over
// A = [h_{t-1} | x_t] of the block's rows; the packed columns of a chunk
// hold the four gates of 8 units side by side (32 * ug + 8 * gate +
// unit), so a thread's accumulator holds i, f, g and o of the same (row,
// unit) pairs and the cell update stays in registers (c: 16 f32 a chunk,
// for all T steps; sigmoid and tanh from __expf and __fdividef, 10 MUFU
// operations a (row, unit)).
//
// What bounds it: a comb layer's products are 2 * 2 * T * B * (F + H) *
// 4H flops (0.17 ms at the bf16 peak at 4096 rows), beside T * 64 * H * 10
// MUFU operations a block (16 a clock an SM: 5.6 us a step at H = 256).
// On the H100 (PERF.md) comb1 takes 0.38-0.40 ms at 4,096 rows: the cell
// updates run after each chunk's products, not under them, and with the
// stream and the MUFU work taken out the products alone took 0.32 ms.
// Turns on the tensor cores (one warpgroup's cell update under the
// other's products, by named barriers), warpgroup 1 starting each step
// half a chunk after warpgroup 0, and the 64 gates of a chunk computed
// before its cells were each no faster.

constexpr int kWgStreamed = 0, kWgResident = 1;    // the designs (KIND)
constexpr int kWgRows = 64;                   // rows of a block
constexpr int kWgK = 64;                      // K of a slab: 128 bytes
constexpr int kWgTile = 128 * kWgK * 2;       // one warpgroup's weight tile
constexpr int kWgTileElems = kWgTile / 2;     // its bf16 elements
constexpr int kWgSlab = kWgRows * kWgK * 2;   // one A slab (64 x 64 bf16)
constexpr int kWgConsumers = 256;             // two warpgroups
constexpr int kWgThreads = kWgConsumers + 128;  // and the producer warpgroup
constexpr int kWgMaxStages = 3;    // a warpgroup's ring (deeper was slower)
constexpr int kWgMaxH = 256;
constexpr int kWgProducerRegs = 40, kWgConsumerRegs = 232;   // setmaxnreg
static_assert(kWgConsumers * kWgConsumerRegs + 128 * kWgProducerRegs <=
                  65536, "the register file of an SM");
// the resident design: x's K padded to 32 (one 64-byte row)
constexpr int kRsKx = 32;
constexpr int kRsMaxF = kRsKx;
constexpr int kRsMaxH = 128;
constexpr int kRsXTile = 128 * kRsKx * 2;     // a chunk's W_ih tile: 8 KB
constexpr int kRsXBuf = kWgRows * kRsKx * 2;  // an x buffer: 4 KB

// byte offset of bf16 element (r, k) of a tile of 128-byte rows in the
// 128-byte swizzle (the 16-byte chunk k / 8 of row r at chunk (k/8) ^ (r%8))
__device__ __forceinline__ int swz(int r, int k) {
  return r * 128 + ((((k >> 3) ^ r) & 7) << 4) + (k & 7) * 2;
}
// the same in a tile of 64-byte rows in the 64-byte swizzle (chunk k / 8
// of row r at chunk (k/8) ^ ((r/2)%4))
__device__ __forceinline__ int swz64(int r, int k) {
  return r * 64 + ((((k >> 3) ^ (r >> 1)) & 3) << 4) + (k & 7) * 2;
}

// d (64 x 128 f32, the m64n128 accumulator layout) = a (64 x 16) @ b
// (16 x 128) + (accumulate ? d : 0), bf16, both K-major in shared memory
// (descriptors). Starting a sum with accumulate = 0, rather than zeroing
// d with other instructions, keeps ptxas from serializing the wgmmas.
__device__ __forceinline__ void wgmma_bf16_m64n128(float (&d)[64],
                                                   uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(accumulate));
}

// x_t of the block's rows into the x slabs (columns [0, nkx * 64); zeros
// past F and past the batch edge), by the 256 consumer threads. vec: 16-
// byte cp.async (completed by the caller's cp_async_wait); else plain
// loads and stores.
__device__ __forceinline__ void stage_x_wg(unsigned char* __restrict__ xbuf,
                                           const bf16* __restrict__ xa,
                                           const bf16* __restrict__ xb,
                                           int t, int B, int b0, int Fa,
                                           int Fb, int nkx, bool vec) {
  const int F = Fa + Fb;
  const int Kx = nkx * kWgK;
  if (vec) {
    const int C8 = Kx / 8;
    for (int i = threadIdx.x; i < kWgRows * C8; i += kWgConsumers) {
      const int r = i / C8;
      const int k = (i - r * C8) * 8;
      const int row = b0 + r;
      const bool ok = row < B && k < F;
      const bf16* src = xa;
      if (ok)
        src = k < Fa ? xa + ((size_t)t * B + row) * Fa + k
                     : xb + ((size_t)t * B + row) * Fb + (k - Fa);
      cp_async16(xbuf + (k >> 6) * kWgSlab + swz(r, k & 63), src, ok);
    }
    return;
  }
  for (int i = threadIdx.x; i < kWgRows * Kx; i += kWgConsumers) {
    const int r = i / Kx;
    const int k = i - r * Kx;
    const int row = b0 + r;
    bf16 v = __float2bfloat16_rn(0.f);
    if (row < B && k < F)
      v = k < Fa ? xa[((size_t)t * B + row) * Fa + k]
                 : xb[((size_t)t * B + row) * Fb + (k - Fa)];
    *reinterpret_cast<bf16*>(xbuf + (k >> 6) * kWgSlab + swz(r, k & 63)) = v;
  }
}

// The cell update of one chunk: accumulator i holds row warp4*16 + gq +
// 8 * ((i >> 1) & 1), packed column 8 * (i >> 2) + 2q + (i & 1); column 32
// * ug + 8 * gate + e' is gate `gate` of unit ub + 8 * ug + e'. h_t, as
// bf16 pairs, goes to hv[2 * ug + rh] (unit ub + 8 ug + 2q and the next,
// row warp4*16 + gq + 8 rh) and, where `store`, to row t_out of ys.
// (Computing all 64 gates first, then the cells, was slower on the H100.)
__device__ __forceinline__ void wg_cell(const float (&acc)[64],
                                        float (&c)[16], uint32_t (&hv)[8],
                                        const float* __restrict__ bd, int ub,
                                        int H, int warp4, int gq, int q,
                                        bf16* __restrict__ ys, int B, int b0,
                                        bool store, int t_out) {
#pragma unroll
  for (int ug = 0; ug < 4; ++ug) {
    const int u0 = ub + ug * 8 + 2 * q;
    float bg[4][2];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        bg[g][e] = u0 + e < H ? __ldg(bd + g * H + u0 + e) : 0.f;
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      bf16 h2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i0 = 16 * ug + 2 * rh + e;
        const float ig = sigmoid_fast(acc[i0] + bg[0][e]);
        const float fg = sigmoid_fast(acc[i0 + 4] + bg[1][e]);
        const float gg = tanh_fast(acc[i0 + 8] + bg[2][e]);
        const float og = sigmoid_fast(acc[i0 + 12] + bg[3][e]);
        float& cs = c[4 * ug + 2 * rh + e];
        cs = fg * cs + ig * gg;
        h2[e] = __float2bfloat16_rn(og * tanh_fast(cs));
      }
      __nv_bfloat162 pair;
      pair.x = h2[0];
      pair.y = h2[1];
      hv[2 * ug + rh] = *reinterpret_cast<uint32_t*>(&pair);
      const int row = b0 + warp4 * 16 + gq + 8 * rh;
      if (store && row < B && u0 < H) {
        bf16* out = ys + ((size_t)t_out * B + row) * H + u0;
        if (u0 + 1 < H && (H & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(out) = pair;
        } else {
          out[0] = h2[0];
          if (u0 + 1 < H) out[1] = h2[1];
        }
      }
    }
  }
}

// a chunk's h (wg_cell's hv) into an h buffer (slabs of 64 units)
__device__ __forceinline__ void wg_store_h(unsigned char* hbuf,
                                           const uint32_t (&hv)[8], int ub,
                                           int warp4, int gq, int q) {
#pragma unroll
  for (int ug = 0; ug < 4; ++ug) {
    const int u0 = ub + ug * 8 + 2 * q;
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int r = warp4 * 16 + gq + 8 * rh;
      *reinterpret_cast<uint32_t*>(hbuf + (u0 >> 6) * kWgSlab +
                                   swz(r, u0 & 63)) = hv[2 * ug + rh];
    }
  }
}

// shared memory of the resident design: the weights, two h buffers, two
// x buffers, the barrier, alignment
__host__ __device__ constexpr int wg_res_weight_bytes(int nch) {
  return 2 * nch * (kRsXTile + nch * kWgTile);
}
inline size_t wg_res_smem(int nch) {
  return (size_t)wg_res_weight_bytes(nch) + 2 * nch * kWgSlab +
         2 * kRsXBuf + sizeof(uint64_t) + 1024;
}

// NCH: chunks of 32 units a warpgroup (Hp = 64 * NCH <= 128)
template <int NCH>
__device__ __forceinline__ void wg_resident(
    const bf16* __restrict__ xa, const bf16* __restrict__ xb,
    const bf16* __restrict__ wp, const float* __restrict__ bias,
    bf16* __restrict__ ys_f, bf16* __restrict__ ys_b, int T_, int B, int Fa,
    int Fb, int H, int seq_out, int vec) {
  constexpr int GRP = kRsXTile + NCH * kWgTile;   // a (warpgroup, chunk)
  constexpr int WB = wg_res_weight_bytes(NCH);    // a direction's weights
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const wsm =
      reinterpret_cast<unsigned char*>(sw_align(smem_raw));
  unsigned char* const hbuf0 = wsm + WB;
  unsigned char* const xbuf0 = hbuf0 + 2 * NCH * kWgSlab;
  const uint32_t wbar = smem_u32(xbuf0 + 2 * kRsXBuf);
  const int d = blockIdx.y;
  const int b0 = blockIdx.x * kWgRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int F = Fa + Fb;

  if (threadIdx.x == 0) {
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kWgProducerRegs));
    if (warp == 8 && lane == 0) {
      // the direction's weights, in copies of at most 32 KB
      mbar_expect_tx(wbar, WB);
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(wp) + (size_t)d * WB;
      for (int off = 0; off < WB; off += 2 * kWgTile) {
        const int n = WB - off < 2 * kWgTile ? WB - off : 2 * kWgTile;
        bulk_load(smem_u32(wsm + off), src + off, n, wbar);
      }
      mbar_wait(wbar, 0);                  // no copy outlives its issuer
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kWgConsumerRegs));
  const int wg = warp >> 2;
  const int warp4 = warp & 3;
  const int gq = lane >> 2, q = lane & 3;
  const float* bd = bias + (size_t)d * 4 * H;
  bf16* ys = d == 0 ? ys_f : ys_b;
  // x: thread i reads columns [8 (i % 4), 8 (i % 4) + 8) of row i / 4
  const int xr = threadIdx.x >> 2, xk = (threadIdx.x & 3) * 8;
  auto load_x = [&](int s) {
    const int t = d == 0 ? s : T_ - 1 - s;
    const int row = b0 + xr;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row >= B || xk >= F) return v;
    if (vec) {                  // Fa, Fb multiples of 8, 16-byte bases
      const bf16* src = xk < Fa ? xa + ((size_t)t * B + row) * Fa + xk
                                : xb + ((size_t)t * B + row) * Fb + (xk - Fa);
      return __ldg(reinterpret_cast<const uint4*>(src));
    }
    auto at = [&](int k) {
      return k < Fa  ? xa[((size_t)t * B + row) * Fa + k]
             : k < F ? xb[((size_t)t * B + row) * Fb + (k - Fa)]
                     : __float2bfloat16_rn(0.f);
    };
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      __nv_bfloat162 p;
      p.x = at(xk + 2 * j);
      p.y = at(xk + 2 * j + 1);
      w[j] = *reinterpret_cast<uint32_t*>(&p);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  };
  auto store_x = [&](unsigned char* buf, uint4 v) {
    *reinterpret_cast<uint4*>(buf + swz64(xr, xk)) = v;
  };
  // h_{-1} = 0 (its padding units stay 0: zero weights and bias give c =
  // 0, h = 0), x_0
  for (int i = threadIdx.x; i < NCH * kWgSlab / 16; i += kWgConsumers)
    reinterpret_cast<uint4*>(hbuf0)[i] = make_uint4(0, 0, 0, 0);
  store_x(xbuf0, load_x(0));
  fence_proxy_async();
  consumers_sync();
  mbar_wait(wbar, 0);                      // the weights are in
  const int nx16 = F <= 16 ? 1 : 2;        // k16 steps of x that are not 0

  float c[NCH][16];
#pragma unroll
  for (int cc = 0; cc < NCH; ++cc)
#pragma unroll
    for (int i = 0; i < 16; ++i) c[cc][i] = 0.f;

  for (int s = 0; s < T_; ++s) {
    const int t = d == 0 ? s : T_ - 1 - s;
    const bool more = s + 1 < T_;
    const unsigned char* hcur = hbuf0 + (s & 1) * NCH * kWgSlab;
    unsigned char* hnxt = hbuf0 + ((s + 1) & 1) * NCH * kWgSlab;
    const unsigned char* xcur = xbuf0 + (s & 1) * kRsXBuf;
    uint4 xv = make_uint4(0, 0, 0, 0);
    if (more) xv = load_x(s + 1);          // lands during the products
    const bool store = seq_out || !more;
    const int t_out = seq_out ? t : 0;
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc) {
      const unsigned char* wx = wsm + (wg * NCH + cc) * GRP;
      const unsigned char* wh = wx + kRsXTile;
      float acc[64];                        // the first wgmma sets it
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (j < nx16)
          wgmma_bf16_m64n128(acc, gmma_desc64(xcur + 32 * j),
                             gmma_desc64(wx + 32 * j), j);
#pragma unroll
      for (int kb = 0; kb < NCH; ++kb)
#pragma unroll
        for (int j = 0; j < kWgK / 16; ++j)
          wgmma_bf16_m64n128(acc, gmma_desc(hcur + kb * kWgSlab + 32 * j),
                             gmma_desc(wh + kb * kWgTile + 32 * j), 1);
      wgmma_commit();
      wgmma_wait<0>();
      const int ub = (wg * NCH + cc) * 32;
      uint32_t hv[8];
      wg_cell(acc, c[cc], hv, bd, ub, H, warp4, gq, q, ys, B, b0, store,
              t_out);
      wg_store_h(hnxt, hv, ub, warp4, gq, q);
    }
    if (more) store_x(xbuf0 + ((s + 1) & 1) * kRsXBuf, xv);
    fence_proxy_async();
    consumers_sync();        // h_t and x_{t+1} in place; h_{t-1} read
  }
}

// shared memory of the streamed design without its rings: one h buffer,
// `xbufs` x buffers, the rings' barriers, alignment
inline size_t wg_fixed_smem(int F, int H, int xbufs) {
  const int nkx = (F + kWgK - 1) / kWgK;
  const int nch = (H + 63) / 64;
  return (size_t)(xbufs * nkx + nch) * kWgSlab +
         2 * 2 * kWgMaxStages * sizeof(uint64_t) + 1024;
}

// NCH: chunks of 32 units a warpgroup (Hp = 64 * NCH <= 256)
template <int NCH>
__device__ __forceinline__ void wg_streamed(
    const bf16* __restrict__ xa, const bf16* __restrict__ xb,
    const bf16* __restrict__ wp, const float* __restrict__ bias,
    bf16* __restrict__ ys_f, bf16* __restrict__ ys_b, int T_, int B, int Fa,
    int Fb, int H, int nkx, int stages, int xbufs, int seq_out, int vec) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // ring w: stages tiles of warpgroup w
  unsigned char* const ring0 =
      reinterpret_cast<unsigned char*>(sw_align(smem_raw));
  unsigned char* const hbuf = ring0 + 2 * stages * kWgTile;
  unsigned char* const xbuf0 = hbuf + NCH * kWgSlab;
  uint64_t* const bars =
      reinterpret_cast<uint64_t*>(xbuf0 + xbufs * nkx * kWgSlab);
  // full[w][i] at bars + w * kWgMaxStages + i, empty[w][i] 2 kWgMaxStages on
  const int nkb = nkx + NCH;                // K slabs: NCH of h, nkx of x
  const int nst = NCH * nkb;                // tiles of a step, a warpgroup
  const int d = blockIdx.y;
  const int b0 = blockIdx.x * kWgRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * kWgMaxStages; ++i) {
      mbar_init(smem_u32(bars + i), 1);
      mbar_init(smem_u32(bars + 2 * kWgMaxStages + i), 4);   // 4 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (warp < 8) {
    // h_{-1} = 0 (its padding units stay 0), x of the first step
    for (int i = threadIdx.x; i < NCH * kWgSlab / 16; i += kWgConsumers)
      reinterpret_cast<uint4*>(hbuf)[i] = make_uint4(0, 0, 0, 0);
    stage_x_wg(xbuf0, xa, xb, d == 0 ? 0 : T_ - 1, B, b0, Fa, Fb, nkx,
               vec != 0);
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
  }
  __syncthreads();       // the barriers set up, x_0 and h_{-1} in place

  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kWgProducerRegs));
    if (warp < 10 && lane == 0) {
      // warpgroup w's producer: its tile of the same nst stages every step
      const int w = warp - 8;
      const bf16* src = wp + ((size_t)d * nst * 2 + w) * kWgTileElems;
      unsigned char* const ring = ring0 + w * stages * kWgTile;
      const uint32_t full0 = smem_u32(bars + w * kWgMaxStages);
      const uint32_t empty0 = smem_u32(bars + (2 + w) * kWgMaxStages);
      int slot = 0;
      uint32_t phase = 0;
      for (int s = 0; s < T_; ++s) {
        for (int i = 0; i < nst; ++i) {
          // the slot's previous use is released (a fresh barrier passes
          // a wait on parity 1 at once)
          mbar_wait(empty0 + 8 * slot, phase ^ 1);
          mbar_expect_tx(full0 + 8 * slot, kWgTile);
          bulk_load(smem_u32(ring + slot * kWgTile),
                    src + (size_t)i * 2 * kWgTileElems, kWgTile,
                    full0 + 8 * slot);
          if (++slot == stages) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
      // every copy has landed before the producer leaves
      for (int i = 0; i < stages; ++i) {
        mbar_wait(empty0 + 8 * slot, phase ^ 1);
        if (++slot == stages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kWgConsumerRegs));
  const int wg = warp >> 2;
  const int warp4 = warp & 3;
  const int gq = lane >> 2, q = lane & 3;
  const float* bd = bias + (size_t)d * 4 * H;
  bf16* ys = d == 0 ? ys_f : ys_b;
  const unsigned char* const ring = ring0 + wg * stages * kWgTile;
  const uint32_t full0 = smem_u32(bars + wg * kWgMaxStages);
  const uint32_t empty0 = smem_u32(bars + (2 + wg) * kWgMaxStages);
  float c[NCH][16];
  uint32_t hv[NCH][8];                      // h_t, held until the buffer
#pragma unroll
  for (int cc = 0; cc < NCH; ++cc)
#pragma unroll
    for (int i = 0; i < 16; ++i) c[cc][i] = 0.f;
  int slot = 0;
  uint32_t phase = 0;

  for (int s = 0; s < T_; ++s) {
    const int t = d == 0 ? s : T_ - 1 - s;
    const bool more = s + 1 < T_;
    const unsigned char* xcur = xbuf0 + (xbufs == 2 ? s & 1 : 0) *
                                            nkx * kWgSlab;
    if (xbufs == 2 && more) {
      // x_{t+1} into the other buffer (read in step s - 1, done) while
      // this step runs; awaited at the step's end
      stage_x_wg(xbuf0 + ((s + 1) & 1) * nkx * kWgSlab, xa, xb,
                 d == 0 ? s + 1 : T_ - 2 - s, B, b0, Fa, Fb, nkx, vec != 0);
      cp_async_commit();
    }
    const bool x_late = xbufs == 1 && s > 0;  // x_t staged after step s-1
    const bool store = seq_out || !more;
    const int t_out = seq_out ? t : 0;
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc) {
      float acc[64];                        // the first wgmma sets it
      for (int kb = 0; kb < nkb; ++kb) {
        if (x_late && cc == 0 && kb == NCH) {
          // x_t is needed from here on: every consumer's copies
          cp_async_wait<0>();
          fence_proxy_async();
          consumers_sync();
        }
        mbar_wait(full0 + 8 * slot, phase);
        const unsigned char* a = kb < NCH ? hbuf + kb * kWgSlab
                                          : xcur + (kb - NCH) * kWgSlab;
        const unsigned char* bt = ring + slot * kWgTile;
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kWgK / 16; ++j)
          wgmma_bf16_m64n128(acc, gmma_desc(a + 32 * j),
                             gmma_desc(bt + 32 * j), kb > 0 || j > 0);
        wgmma_commit();
        wgmma_wait<0>();                    // the tile is free at once
        if (lane == 0) mbar_arrive(empty0 + 8 * slot);
        if (++slot == stages) {
          slot = 0;
          phase ^= 1;
        }
      }
      wg_cell(acc, c[cc], hv[cc], bd, (wg * NCH + cc) * 32, H, warp4, gq, q,
              ys, B, b0, store, t_out);
    }
    if (!more) break;                       // h_{T-1} feeds no product
    consumers_sync();        // every product of step s is done
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc)
      wg_store_h(hbuf, hv[cc], (wg * NCH + cc) * 32, warp4, gq, q);
    if (xbufs == 1) {
      // x_{t+1} into the one buffer, awaited before its first x slab
      stage_x_wg(xbuf0, xa, xb, d == 0 ? s + 1 : T_ - 2 - s, B, b0, Fa, Fb,
                 nkx, vec != 0);
      cp_async_commit();
    } else {
      cp_async_wait<0>();                   // x_{t+1} has landed
    }
    fence_proxy_async();
    consumers_sync();        // h_t is in the buffer
  }
}

// NCH: chunks of 32 units a warpgroup; KIND: kWgStreamed or kWgResident
template <int NCH, int KIND>
__global__ void __launch_bounds__(kWgThreads, 1)
fused_bilstm_wgmma_kernel(const bf16* __restrict__ xa,
                          const bf16* __restrict__ xb,
                          const bf16* __restrict__ wp,
                          const float* __restrict__ bias,
                          bf16* __restrict__ ys_f, bf16* __restrict__ ys_b,
                          int T_, int B, int Fa, int Fb, int H, int nkx,
                          int stages, int xbufs, int seq_out, int vec) {
  if constexpr (KIND == kWgResident)
    wg_resident<NCH>(xa, xb, wp, bias, ys_f, ys_b, T_, B, Fa, Fb, H, seq_out,
                     vec);
  else
    wg_streamed<NCH>(xa, xb, wp, bias, ys_f, ys_b, T_, B, Fa, Fb, H, nkx,
                     stages, xbufs, seq_out, vec);
}

// x slabs of a width: ceil(F / 64)
inline int wg_x_slabs(int F) { return (F + kWgK - 1) / kWgK; }

template <int NCH, int KIND>
cudaError_t launch_wgmma_kernel(const bf16* xa, const bf16* xb,
                                const bf16* wp, const float* bias,
                                bf16* ys_f, bf16* ys_b, int T_, int B,
                                int Fa, int Fb, int H, int seq_out,
                                int stages, int xbufs, int vec,
                                cudaStream_t stream) {
  const int nkx = wg_x_slabs(Fa + Fb);
  const size_t smem =
      KIND == kWgResident
          ? wg_res_smem(NCH)
          : wg_fixed_smem(Fa + Fb, H, xbufs) + (size_t)stages * 2 * kWgTile;
  auto kernel = fused_bilstm_wgmma_kernel<NCH, KIND>;
  const cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + kWgRows - 1) / kWgRows, 2);
  kernel<<<grid, kWgThreads, smem, stream>>>(xa, xb, wp, bias, ys_f, ys_b,
                                             T_, B, Fa, Fb, H, nkx, stages,
                                             xbufs, seq_out, vec);
  return cudaGetLastError();
}

cudaError_t launch_wgmma(const bf16* xa, const bf16* xb, const bf16* wp,
                         const float* bias, bf16* ys_f, bf16* ys_b, int T_,
                         int B, int Fa, int Fb, int H, int seq_out, int kind,
                         int stages, int xbufs, cudaStream_t stream) {
  const int vec = x_vec(xa, xb, Fa, Fb);
  const int nch = (H + 63) / 64;
  if (kind == kWgResident) {
    if (Fa + Fb > kRsMaxF || H > kRsMaxH) return cudaErrorInvalidValue;
    if (nch == 1)
      return launch_wgmma_kernel<1, kWgResident>(
          xa, xb, wp, bias, ys_f, ys_b, T_, B, Fa, Fb, H, seq_out, 0, 0, vec,
          stream);
    return launch_wgmma_kernel<2, kWgResident>(
        xa, xb, wp, bias, ys_f, ys_b, T_, B, Fa, Fb, H, seq_out, 0, 0, vec,
        stream);
  }
  if (kind != kWgStreamed || stages < 2 || stages > kWgMaxStages ||
      !(xbufs == 1 || xbufs == 2))
    return cudaErrorInvalidValue;
  switch (nch) {
    case 1: return launch_wgmma_kernel<1, kWgStreamed>(
        xa, xb, wp, bias, ys_f, ys_b, T_, B, Fa, Fb, H, seq_out, stages,
        xbufs, vec, stream);
    case 2: return launch_wgmma_kernel<2, kWgStreamed>(
        xa, xb, wp, bias, ys_f, ys_b, T_, B, Fa, Fb, H, seq_out, stages,
        xbufs, vec, stream);
    case 3: return launch_wgmma_kernel<3, kWgStreamed>(
        xa, xb, wp, bias, ys_f, ys_b, T_, B, Fa, Fb, H, seq_out, stages,
        xbufs, vec, stream);
    default: return launch_wgmma_kernel<4, kWgStreamed>(
        xa, xb, wp, bias, ys_f, ys_b, T_, B, Fa, Fb, H, seq_out, stages,
        xbufs, vec, stream);
  }
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

// float32, the narrow kernel: x* (T, B, F*) row-major, Fa + Fb <= 32;
// wp (2, Kx + H, 4H) the packed, swizzled [W_ih; W_hh] described above
// (ops/fused_lstm.py::pack_narrow_weights; Kx = round_up(Fa + Fb, 8)),
// 16-byte aligned; bias (2, 4H); ys_f/ys_b (T or 1, B, H); the plan
// (ops/fused_lstm.py::narrow_plan): clusters of `cluster` blocks of H /
// cluster = 32 or 64 units, row tiles of `rows` (16 to 128, a multiple
// of 16). Runs on `stream`, allocates nothing, returns the launch's
// error code (cudaErrorInvalidValue for a plan it has no kernel for or
// whose shared memory outgrows a block's).
cudaError_t dsp_fused_bilstm_f32_narrow(const void* xa, const void* xb,
                                        const void* wp, const void* bias,
                                        void* ys_f, void* ys_b, int T_,
                                        int B, int Fa, int Fb, int H,
                                        int seq_out, int cluster, int rows,
                                        void* stream) {
  if (T_ < 1 || B < 1 || Fa < 1 || Fb < 0 || (Fb > 0 && xb == nullptr) ||
      reinterpret_cast<uintptr_t>(wp) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ys_f) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(ys_b) % 8 != 0)
    return cudaErrorInvalidValue;
  const void* kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = narrow_config(Fa + Fb, H, cluster, rows,
                                  (B + rows - 1) / rows,
                                  static_cast<cudaStream_t>(stream), &kernel,
                                  &cfg, &attr);
  if (err != cudaSuccess) return err;
  void* args[] = {&xa, &xb, &wp, &bias, &ys_f, &ys_b, &T_, &B, &Fa, &Fb,
                  &seq_out};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of the narrow kernel's plan (cluster, rows) at
// input width F and hidden size H the card holds at once
// (cudaOccupancyMaxActiveClusters at the kernel's shared memory), into
// *clusters; refuses a plan the launcher refuses.
cudaError_t dsp_fused_bilstm_narrow_clusters(int F, int H, int cluster,
                                             int rows, int* clusters) {
  if (clusters == nullptr) return cudaErrorInvalidValue;
  const void* kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t err = narrow_config(F, H, cluster, rows, 1, nullptr,
                                        &kernel, &cfg, &attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
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

// bfloat16 on wgmma: x* (T, B, F*) and ys_f/ys_b (T or 1, B, H) bf16; wp
// 16-byte aligned, the weights packed for the design `kind`: kWgStreamed
// (ops/fused_lstm.py::pack_weights_wgmma: 2 * ceil(H/64) * (ceil(F/64) +
// ceil(H/64)) stages of two 16 KB tiles a direction, in stream order) with
// `stages` (2 or 3) ring tiles a warpgroup and `xbufs` (1 or 2) x buffers,
// or kWgResident (pack_weights_resident; F <= 32, H <= 128; `stages` and
// `xbufs` unused); bias (2, 4H) f32; H <= 256; the plan from
// ops/fused_lstm.py::wgmma_plan. Runs on `stream`, allocates nothing,
// returns the launch's error code (cudaErrorInvalidValue for a plan the
// kernel does not take or whose shared memory outgrows a block's).
cudaError_t dsp_fused_bilstm_bf16_wgmma(const void* xa, const void* xb,
                                        const void* wp, const void* bias,
                                        void* ys_f, void* ys_b, int T_,
                                        int B, int Fa, int Fb, int H,
                                        int seq_out, int kind, int stages,
                                        int xbufs, void* stream) {
  if (T_ < 1 || B < 1 || Fa < 1 || Fb < 0 || H < 1 || H > kWgMaxH ||
      (Fb > 0 && xb == nullptr) ||
      reinterpret_cast<uintptr_t>(wp) % 16 != 0)
    return cudaErrorInvalidValue;
  return launch_wgmma(static_cast<const bf16*>(xa),
                      static_cast<const bf16*>(xb),
                      static_cast<const bf16*>(wp),
                      static_cast<const float*>(bias),
                      static_cast<bf16*>(ys_f), static_cast<bf16*>(ys_b), T_,
                      B, Fa, Fb, H, seq_out, kind, stages, xbufs,
                      static_cast<cudaStream_t>(stream));
}

const char* dsp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
