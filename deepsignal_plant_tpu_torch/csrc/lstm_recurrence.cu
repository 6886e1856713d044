// Trainable BiLSTM recurrence for Hopper (sm_90a): the forward over a
// precomputed input projection, with or without the residuals, and its
// backward (BPTT), in three launchers.
//
// Replaces the Pallas TPU kernels of deepsignal_plant_tpu/ops/pallas_lstm.py:
//   dsp_lstm_recurrence_fwd, save=0  <- _lstm_kernel (K2, pallas_call :94)
//   dsp_lstm_recurrence_fwd, save=1  <- _lstm_fwd_save_kernel (K3, :225)
//   dsp_lstm_recurrence_bwd          <- _lstm_bwd_kernel (K4, :282): the
//                                       reverse-time recurrence
//   dsp_lstm_dw_hh                   <- _lstm_bwd_kernel (K4): its dW_hh
//                                       accumulation, as a kernel of its own
//   dsp_k1_rec_f32,                  <- the recurrence of pallas_fused.py's
//   dsp_lstm_recurrence_fwd_k1          _fused_kernel (K1) at float32, over
//                                       the projection of fused_bilstm.cu:
//                                       K1's own wgmma kernel (k1_rec,
//                                       call_mods' 4096-row tiles) or K2's
//                                       float32 kernels in K1's order
//
// Tensor contract (pallas_lstm.py:11-16): xproj (T, 2, B, 4H) holds the
// input projections with the bias, gate order i,f,g,o, direction 1
// already time-flipped, so step s of either direction reads xproj[s, d];
// w_hh (2, H, 4H); ys (T, 2, B, H) per-step h in the same step order
// (direction 1 stays flipped). The residuals are cs (T, 2, B, H) float32
// and the activated gates (T, 2, B, 4H) in the storage type.
//
// Numerics contract (pallas_lstm.py:40-54, :131-208): xproj, w_hh, ys,
// gates and dxproj are stored in float32 or bfloat16; products accumulate
// in f32; gate math, the cell state and the dh/dc carries are f32; h is
// rounded to the storage type after every step (the next step's
// operand); da is rounded to the storage type before it feeds dh_{t-1} =
// da @ W_hh^T (:204) and dW_hh = sum_t h_{t-1}^T da_t (:207).
//
// Design, shared with fused_bilstm.cu (K1): the TPU kernels walk T as a
// sequential grid axis with h and c (or dh and dc) in VMEM scratch;
// Hopper runs blocks in no order, so the time loop lives inside the
// block: a block (or a cluster of blocks) owns BB batch rows of one
// direction for all T steps. The cell state and the carries stay in f32
// registers of the thread that owns their (row, unit). bfloat16 runs its
// per-step product on the tensor cores (mma.sync m16n8k16, f32
// accumulate); float32 on the tensor cores in 3xTF32 (mma.sync m16n8k8,
// three tf32 products per f32 product) in its cluster kernels and dW_hh,
// and on the CUDA cores (FFMA) in its streaming kernels. The ragged batch
// edge is masked in the kernel: rows >= B read zeros and store nothing,
// with no padding on the host (the JAX wrapper pads B to a multiple of
// 128, pallas_lstm.py:219-223).
//
// Each storage type has two designs, chosen per launch by the wrapper's
// plan (ops/recurrence.py::recurrence_plan; K1's float32 recurrence has a
// third, k1_rec below, which k1_rec_plan weighs against the cluster
// kernel):
// - the cluster kernels (H = 128 and 256, the training path's widths): a
//   thread-block cluster of C blocks owns a row tile, block r owns H/C
//   hidden units (64 in bfloat16, 32 in float32) and keeps their slice of
//   W_hh[d] resident in shared memory for the whole launch; h_s (forward)
//   or the partial sums of dh_{s-1} (backward) cross the cluster through
//   distributed shared memory, one or two cluster barriers per step;
// - the streaming kernels (every other H, up to 512, and shapes with no
//   plan): grid (ceil(B / BB), 2), one block per row tile; one direction's
//   W_hh (512 KB in bf16 at H=256, more than a block's 227 KB) is read
//   from L2 at every step (bfloat16 packs it per launch into the caller's
//   workspace); h (or da) is exchanged through shared memory.
//
// The TPU's K4 keeps a (2, H, 4H) f32 dW_hh accumulator per batch tile
// in VMEM (1 MB per direction at H=256), which no block here can hold.
// So dW_hh is a second pass over the stored operands: dsp_lstm_dw_hh, a
// split-K product over K = (T-1)*B rows whose f32 partials are summed in
// a fixed order, with no atomics (deterministic).

#include <cooperative_groups.h>

#include "dsp_common.cuh"

using namespace dsp;
namespace cg = cooperative_groups;

namespace {

constexpr int kMmaWarps = 8;            // warps of a recurrence block
constexpr int kRowsPerThread = 16;      // float32: rows of one thread
constexpr int kTargetThreads = 256;     // float32: threads of a block
constexpr int kMaxHidden = 512;

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// out[d][n][k] for n < rows, k < Kp: in[d][k][n] (transpose; in is
// (2, K, rows)) or in[d][n][k] (copy; in is (2, rows, K)) for k < K, 0
// for K <= k < Kp.
template <typename T>
__global__ void pack_kernel(const T* __restrict__ in, T* __restrict__ out,
                            int rows, int K, int Kp, int transpose) {
  const size_t total = (size_t)2 * rows * Kp;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int k = (int)(i % Kp);
    const size_t dn = i / Kp;
    const int n = (int)(dn % rows);
    const int d = (int)(dn / rows);
    T v = T(0.f);
    if (k < K)
      v = transpose ? in[((size_t)d * K + k) * rows + n]
                    : in[((size_t)d * rows + n) * K + k];
    out[i] = v;
  }
}

template <typename T>
cudaError_t pack(const T* in, T* out, int rows, int K, int Kp, int transpose,
                 cudaStream_t stream) {
  const size_t total = (size_t)2 * rows * Kp;
  const int blocks = (int)(total / 256 + 1 < 1024 ? total / 256 + 1 : 1024);
  pack_kernel<T><<<blocks, 256, 0, stream>>>(in, out, rows, K, Kp, transpose);
  return cudaGetLastError();
}

__device__ __forceinline__ float ld_f(const float* p) { return *p; }
__device__ __forceinline__ float ld_f(const bf16* p) {
  return __bfloat162float(*p);
}
// v rounded to the storage type of p, as float
__device__ __forceinline__ float rounded(const float*, float v) { return v; }
__device__ __forceinline__ float rounded(const bf16*, float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void st_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_f(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// forward (K2, K3), bfloat16 on the tensor cores: the streaming kernel
//
// A block owns 16*MT rows. A warp owns groups of 8 hidden units; for a
// group it accumulates four 16x8 tiles per m16 tile, one per gate, over
// the same 8 units, so a thread's accumulator fragments hold i, f, g and
// o of the same (row, unit) pairs and the cell update needs no exchange.
// The accumulators start from xproj[s]. The A operand, h_{s-1} of the
// block's rows, is double-buffered in shared memory; the B operand is
// W_hh[d] transposed to (4H, Kp), Kp = round_up(H, 32), zero-padded by a
// packing kernel, so one 16-byte load gives a thread its fragments of two
// k16 steps (the k order is permuted alike in A and B; the sum is
// unchanged).

template <int GPW, int MT, bool SAVE>
__global__ void __launch_bounds__(kMmaWarps * 32, 1)
fwd_bf16_kernel(const bf16* __restrict__ xproj, const bf16* __restrict__ wt,
                bf16* __restrict__ ys, float* __restrict__ cs,
                bf16* __restrict__ gates, int T_, int B, int H, int Kp,
                int Ks) {
  constexpr int BB = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const buf0 = reinterpret_cast<bf16*>(smem_raw);
  bf16* const buf1 = buf0 + BB * Ks;
  const int d = blockIdx.y;
  const int G4 = 4 * H;
  const int b0 = blockIdx.x * BB;
  const int nwarps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int gq = (threadIdx.x % 32) >> 2;   // groupID of the fragments
  const int q = threadIdx.x & 3;            // thread in the group
  const int ngroups = (H + 7) / 8;
  const bf16* w = wt + (size_t)d * G4 * Kp;

  // h_{-1} = 0 and the pad columns [H, Kp) = 0 in both buffers
  for (int i = threadIdx.x; i < 2 * BB * Ks / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  float c[GPW][MT][4];
#pragma unroll
  for (int gi = 0; gi < GPW; ++gi)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[gi][mt][e] = 0.f;

  for (int s = 0; s < T_; ++s) {
    const bf16* cur = s & 1 ? buf1 : buf0;
    bf16* nxt = s & 1 ? buf0 : buf1;
    const size_t step = (size_t)s * 2 + d;   // (s, d) of the (T, 2, ...) arrays

#pragma unroll
    for (int gi = 0; gi < GPW; ++gi) {
      const int grp = warp + gi * nwarps;
      if (grp >= ngroups) break;            // the same for the whole warp
      const int j0 = grp * 8;
      const bool bvalid = j0 + gq < H;
      const bf16* wrow = w + (size_t)(j0 + gq) * Kp + 8 * q;
      // accumulator fragment element e: row gq + 8*(e/2) of the m16 tile,
      // unit u + e%2
      const int u = j0 + 2 * q;
      float acc[MT][4][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = b0 + mt * 16 + gq + (e >> 1) * 8;
          const int j = u + (e & 1);
          const bool ok = row < B && j < H;
          const bf16* xr = xproj + (step * B + row) * G4 + j;
#pragma unroll
          for (int gate = 0; gate < 4; ++gate)
            acc[mt][gate][e] = ok ? __bfloat162float(xr[gate * H]) : 0.f;
        }
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
            nxt[r * Ks + j] = h;
            const int row = b0 + r;
            if (row < B) {
              const size_t hi_ = (step * B + row) * H + j;
              ys[hi_] = h;
              if (SAVE) {
                cs[hi_] = c[gi][mt][e];
                bf16* gr = gates + (step * B + row) * G4 + j;
                gr[0] = __float2bfloat16_rn(ig);
                gr[H] = __float2bfloat16_rn(fg);
                gr[2 * H] = __float2bfloat16_rn(gg);
                gr[3 * H] = __float2bfloat16_rn(og);
              }
            }
          }
        }
      }
    }
    __syncthreads();                        // h_s is in nxt
  }
}

// ---------------------------------------------------------------------------
// where the float32 forward kernels store h: K2 and K3 keep ys (T, 2, B,
// H) in step order (kYsSteps); K1's float32 route (ops/fused_lstm.py)
// stores each direction's states as K1 does, ys_f and ys_b (T, B, H) in
// true time (kYsTrueTime), or only the last step's as (1, B, H)
// (kYsFinal). The address of h of step s, direction d, batch row `row`
// (unit 0), or null where that step stores nothing.

enum YsMode { kYsSteps = 0, kYsTrueTime = 1, kYsFinal = 2 };

__device__ __forceinline__ float* ys_row(float* ys, float* ys_b, int mode,
                                         int s, int d, int T_, int B, int H,
                                         int row) {
  if (mode == kYsSteps) return ys + (((size_t)s * 2 + d) * B + row) * H;
  if (mode == kYsFinal && s != T_ - 1) return nullptr;
  const int t = mode == kYsFinal ? 0 : d ? T_ - 1 - s : s;
  return (d ? ys_b : ys) + ((size_t)t * B + row) * H;
}

// ---------------------------------------------------------------------------
// forward (K2, K3), float32 on the CUDA cores: the streaming kernel
//
// block = (round_up(H, 32), max(1, 256 / that)) threads; thread (j, y)
// owns unit j for RB rows; h_{s-1} is kept transposed ([k][row]) in shared
// memory so one 16-byte load feeds four rows; two barriers per step.
// ys_b and mode: ys_row (SAVE only with kYsSteps).

template <int RB, bool SAVE>
__global__ void __launch_bounds__(kMaxHidden)
fwd_f32_kernel(const float* __restrict__ xproj, const float* __restrict__ w_hh,
               float* __restrict__ ys, float* __restrict__ ys_b,
               float* __restrict__ cs, float* __restrict__ gates, int T_,
               int B, int H, int mode) {
  extern __shared__ __align__(16) float hs[];    // [H][BB]
  const int d = blockIdx.y;
  const int G4 = 4 * H;
  const int BB = RB * blockDim.y;
  const int b0 = blockIdx.x * BB;
  const int j = threadIdx.x;
  const int rg = threadIdx.y * RB;
  const bool active = j < H;
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const float* wh = w_hh + (size_t)d * H * G4;

  float c[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) c[r] = 0.f;
  for (int i = tid; i < H * BB; i += nthreads) hs[i] = 0.f;
  __syncthreads();

  for (int s = 0; s < T_; ++s) {
    const size_t step = (size_t)s * 2 + d;
    float acc[4][RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int row = b0 + rg + r;
      const bool ok = active && row < B;
      const float* xr = xproj + (step * B + row) * G4 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[g][r] = ok ? xr[g * H] : 0.f;
    }
    if (active) accumulate<RB>(acc, hs, wh, H, H, BB, rg, j);
    __syncthreads();                        // every read of h_{s-1} done

    if (active) {
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
        if (row < B) {
          const size_t hi = (step * B + row) * H + j;
          float* yr = ys_row(ys, ys_b, mode, s, d, T_, B, H, row);
          if (yr != nullptr) yr[j] = h;
          if (SAVE) {
            cs[hi] = c[r];
            float* gr = gates + (step * B + row) * G4 + j;
            gr[0] = ig; gr[H] = fg; gr[2 * H] = gg; gr[3 * H] = og;
          }
        }
      }
    }
    __syncthreads();                        // h_s written
  }
}

// ---------------------------------------------------------------------------
// backward recurrence (K4), shared elementwise part
//
// One (row, unit j) of step s: from the saved activated gates and cell
// states and the incoming dy, with the carries dh (= da_{s+1} @ W_hh^T)
// and dc, the four da's of unit j (pallas_lstm.py:181-206). Writes the
// storage-type da to `da` (stride H between gates) and returns the
// rounded values through `out` for the product; updates dc.

template <typename S>
__device__ __forceinline__ void bwd_cell(const S* __restrict__ gr,
                                         float c_t, float c_prev, float dy,
                                         float dh, float& dc,
                                         S* __restrict__ dxr, int H,
                                         float (&out)[4]) {
  const float ig = ld_f(gr);
  const float fg = ld_f(gr + H);
  const float gg = ld_f(gr + 2 * H);
  const float og = ld_f(gr + 3 * H);
  const float tanh_c = tanhf(c_t);
  const float dh_t = dy + dh;
  const float dc_t = dc + dh_t * og * (1.f - tanh_c * tanh_c);
  const float da[4] = {dc_t * gg * ig * (1.f - ig),
                       dc_t * c_prev * fg * (1.f - fg),
                       dc_t * ig * (1.f - gg * gg),
                       dh_t * tanh_c * og * (1.f - og)};
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    st_f(dxr + g * H, da[g]);
    out[g] = rounded(dxr, da[g]);           // the stored value
  }
  dc = dc_t * fg;
}

// ---------------------------------------------------------------------------
// backward recurrence (K4), bfloat16 on the tensor cores: the streaming
// kernel
//
// Steps run in reverse. A thread owns the (row, unit) pairs of its
// accumulator fragments for groups of 8 units: there it computes the four
// da's, keeps dc, and receives dh_{s-1} = da_s @ W_hh^T from its own mma
// tiles (M = rows, N = units, K = 4H), so the carries never leave its
// registers. da_s of the block's rows (all 4H columns) is the A operand,
// double-buffered in shared memory; the B operand is W_hh[d] (rows =
// units, 4H contiguous) zero-padded to Kp = round_up(4H, 32).

template <int GPW, int MT>
__global__ void __launch_bounds__(kMmaWarps * 32, 1)
bwd_bf16_kernel(const bf16* __restrict__ dys, const float* __restrict__ cs,
                const bf16* __restrict__ gates, const bf16* __restrict__ wb,
                bf16* __restrict__ dx, int T_, int B, int H, int Kp, int Ks) {
  constexpr int BB = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const buf0 = reinterpret_cast<bf16*>(smem_raw);
  bf16* const buf1 = buf0 + BB * Ks;
  const int d = blockIdx.y;
  const int G4 = 4 * H;
  const int b0 = blockIdx.x * BB;
  const int nwarps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int gq = (threadIdx.x % 32) >> 2;
  const int q = threadIdx.x & 3;
  const int ngroups = (H + 7) / 8;
  const bf16* w = wb + (size_t)d * H * Kp;

  // the pad columns [4H, Kp) stay 0 in both buffers
  for (int i = threadIdx.x; i < 2 * BB * Ks / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  float dh[GPW][MT][4], dc[GPW][MT][4];
#pragma unroll
  for (int gi = 0; gi < GPW; ++gi)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dh[gi][mt][e] = dc[gi][mt][e] = 0.f;

  for (int s = T_ - 1; s >= 0; --s) {
    bf16* buf = (T_ - 1 - s) & 1 ? buf1 : buf0;
    const size_t step = (size_t)s * 2 + d;
    const size_t prev = (size_t)(s - 1) * 2 + d;   // used only for s > 0

#pragma unroll
    for (int gi = 0; gi < GPW; ++gi) {
      const int grp = warp + gi * nwarps;
      if (grp >= ngroups) break;
      const int u = grp * 8 + 2 * q;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = mt * 16 + gq + (e >> 1) * 8;
          const int row = b0 + r;
          const int j = u + (e & 1);
          if (j >= H) continue;
          bf16* ar = buf + r * Ks + j;
          if (row >= B) {                   // rows past the edge: da = 0
#pragma unroll
            for (int g = 0; g < 4; ++g) ar[g * H] = __float2bfloat16_rn(0.f);
            continue;
          }
          const size_t hi = (step * B + row) * H + j;
          const float c_prev = s > 0 ? cs[(prev * B + row) * H + j] : 0.f;
          float da[4];
          bwd_cell<bf16>(gates + (step * B + row) * G4 + j, cs[hi], c_prev,
                         __bfloat162float(dys[hi]), dh[gi][mt][e],
                         dc[gi][mt][e], dx + (step * B + row) * G4 + j, H,
                         da);
#pragma unroll
          for (int g = 0; g < 4; ++g) ar[g * H] = __float2bfloat16_rn(da[g]);
        }
      }
    }
    if (s == 0) break;                      // dh_{-1} is not needed
    __syncthreads();                        // da_s of every unit is in buf

#pragma unroll
    for (int gi = 0; gi < GPW; ++gi) {
      const int grp = warp + gi * nwarps;
      if (grp >= ngroups) break;
      const int j0 = grp * 8;
      const bool bvalid = j0 + gq < H;
      const bf16* wrow = w + (size_t)(j0 + gq) * Kp + 8 * q;
      float acc[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
#pragma unroll 4
      for (int k0 = 0; k0 < Kp; k0 += 32) {
        const uint4 bq = bvalid
            ? *reinterpret_cast<const uint4*>(wrow + k0)
            : make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const bf16* arow = buf + (mt * 16 + gq) * Ks + k0 + 8 * q;
          const uint4 lo = *reinterpret_cast<const uint4*>(arow);
          const uint4 hi = *reinterpret_cast<const uint4*>(arow + 8 * Ks);
          mma_bf16(acc[mt], lo.x, hi.x, lo.y, hi.y, bq.x, bq.y);
          mma_bf16(acc[mt], lo.z, hi.z, lo.w, hi.w, bq.z, bq.w);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dh[gi][mt][e] = acc[mt][e];
    }
    // no barrier: the next step writes the other buffer, and the barrier
    // after that orders this step's reads before this buffer is reused
  }
}

// ---------------------------------------------------------------------------
// backward recurrence (K4), float32 on the CUDA cores: the streaming
// kernel
//
// Thread (j, y) owns unit j for RB rows; da_s is kept transposed
// ([4H][row]) in shared memory; W_hh[d] is packed transposed to (4H, H) so
// neighbouring threads read neighbouring weights; two barriers per step.

template <int RB>
__global__ void __launch_bounds__(kMaxHidden)
bwd_f32_kernel(const float* __restrict__ dys, const float* __restrict__ cs,
               const float* __restrict__ gates, const float* __restrict__ wT,
               float* __restrict__ dx, int T_, int B, int H) {
  extern __shared__ __align__(16) float das[];   // [4H][BB]
  const int d = blockIdx.y;
  const int G4 = 4 * H;
  const int BB = RB * blockDim.y;
  const int b0 = blockIdx.x * BB;
  const int j = threadIdx.x;
  const int rg = threadIdx.y * RB;
  const bool active = j < H;
  const float* w = wT + (size_t)d * G4 * H;

  float dh[RB], dc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) dh[r] = dc[r] = 0.f;

  for (int s = T_ - 1; s >= 0; --s) {
    const size_t step = (size_t)s * 2 + d;
    const size_t prev = (size_t)(s - 1) * 2 + d;
    if (active) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const int row = b0 + rg + r;
        float da[4] = {0.f, 0.f, 0.f, 0.f};
        if (row < B) {
          const size_t hi = (step * B + row) * H + j;
          const float c_prev = s > 0 ? cs[(prev * B + row) * H + j] : 0.f;
          bwd_cell<float>(gates + (step * B + row) * G4 + j, cs[hi], c_prev,
                          dys[hi], dh[r], dc[r],
                          dx + (step * B + row) * G4 + j, H, da);
        }
#pragma unroll
        for (int g = 0; g < 4; ++g) das[(g * H + j) * BB + rg + r] = da[g];
      }
    }
    if (s == 0) break;
    __syncthreads();                        // da_s of every unit is in das
    if (active) {
#pragma unroll
      for (int r = 0; r < RB; ++r) dh[r] = 0.f;
#pragma unroll 4
      for (int k = 0; k < G4; ++k) {
        const float wk = w[(size_t)k * H + j];
        const float* ak = das + k * BB + rg;
#pragma unroll
        for (int r = 0; r < RB; r += 4) {
          const float4 v = *reinterpret_cast<const float4*>(ak + r);
          dh[r] += v.x * wk; dh[r + 1] += v.y * wk;
          dh[r + 2] += v.z * wk; dh[r + 3] += v.w * wk;
        }
      }
    }
    __syncthreads();                        // every read of das done
  }
}

// ---------------------------------------------------------------------------
// dW_hh (K4): dW[d] = sum_{s >= 1, b} ys[s-1, d, b, :]^T dx[s, d, b, :],
// (H, 4H) f32, as a split-K product. K row k (0 <= k < (T-1)*B) is batch
// row k % B of step 1 + k / B. The K rows are cut into `splits`
// contiguous ranges of `rows` rows (ops/recurrence.py::dw_hh_split_plan
// chooses them for the card's SM count; any plan that covers K runs);
// a block computes one kDwM x kDwN output tile over one range, streaming
// it through shared-memory slabs (bfloat16: a ring of kDwStages that
// cp.async fills while the previous slabs' products run; float32: two,
// transposed as they are staged), and writes an f32 partial.
// dw_reduce_kernel then sums the partials in split order. No atomics: two
// launches on the same inputs give the same bits.

constexpr int kDwM = 128;                   // output tile: units of h_prev
constexpr int kDwN = 128;                   // output tile: gate columns
constexpr int kDwStages = 3;                // slabs in the ring
constexpr int kDwThreads = 256;
constexpr int kDwKBf16 = 64;                // slab rows, bfloat16
constexpr int kDwKF32 = 32;                 // slab rows, float32
constexpr int kDwLdaBf16 = kDwM + 8;        // smem rows of 272 bytes:
constexpr int kDwLdbBf16 = kDwN + 8;        // ldmatrix conflict-free

// element offsets of K row k's A row (in ys) and B row (in dx)
struct DwRow {
  size_t a, b;
};
__device__ __forceinline__ DwRow dw_row(int k, int d, int B, int H) {
  const int s = 1 + k / B;
  const int b = k - (s - 1) * B;
  return {(((size_t)(s - 1) * 2 + d) * B + b) * H,
          (((size_t)s * 2 + d) * B + b) * (size_t)(4 * H)};
}

// One slab: K rows [k0, k0 + KS) of A (KS x kDwM, columns m0..) and B
// (KS x kDwN, columns n0..), as stored (k rows; m or n contiguous). Rows
// >= kend and columns past the operand's width read zeros. vec: 16-byte
// cp.async (row widths a multiple of 16 bytes, 16-byte aligned bases),
// completed by the caller's cp_async_wait; else plain loads and stores.
template <typename S, int KS, int LDA, int LDB>
__device__ __forceinline__ void dw_stage(S* __restrict__ As,
                                         S* __restrict__ Bs,
                                         const S* __restrict__ ys,
                                         const S* __restrict__ dx, int k0,
                                         int kend, int d, int B, int H,
                                         int m0, int n0, bool vec) {
  const int G4 = 4 * H;
  if (vec) {
    constexpr int E = 16 / sizeof(S);       // elements of a 16-byte chunk
    constexpr int CA = kDwM / E, CB = kDwN / E;
    for (int i = threadIdx.x; i < KS * (CA + CB); i += kDwThreads) {
      const bool is_a = i < KS * CA;
      const int j = is_a ? i : i - KS * CA;
      const int C = is_a ? CA : CB;
      const int r = j / C;
      const int c = (j - r * C) * E;
      const int k = k0 + r;
      const int col = (is_a ? m0 : n0) + c;
      const bool ok = k < kend && col < (is_a ? H : G4);
      const S* src = is_a ? ys : dx;
      if (ok) {
        const DwRow o = dw_row(k, d, B, H);
        src += (is_a ? o.a : o.b) + col;
      }
      cp_async16(is_a ? As + r * LDA + c : Bs + r * LDB + c, src, ok);
    }
    return;
  }
  for (int i = threadIdx.x; i < KS * (kDwM + kDwN); i += kDwThreads) {
    const bool is_a = i < KS * kDwM;
    const int j = is_a ? i : i - KS * kDwM;
    const int W = is_a ? kDwM : kDwN;
    const int r = j / W;
    const int c = j - r * W;
    const int k = k0 + r;
    const int col = (is_a ? m0 : n0) + c;
    S v = S(0.f);
    if (k < kend && col < (is_a ? H : G4)) {
      const DwRow o = dw_row(k, d, B, H);
      v = is_a ? ys[o.a + col] : dx[o.b + col];
    }
    (is_a ? As + r * LDA : Bs + r * LDB)[c] = v;
  }
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// the block's K range [kbeg, kend) and slab count; grid z = 2 * split + d
struct DwSplit {
  int d, split, kbeg, kend, nslab;
};
__device__ __forceinline__ DwSplit dw_split(int K, int rows, int KS) {
  DwSplit p;
  p.d = blockIdx.z & 1;
  p.split = blockIdx.z >> 1;
  p.kbeg = p.split * rows;
  p.kend = min(p.kbeg + rows, K);
  p.nslab = p.kend > p.kbeg ? (p.kend - p.kbeg + KS - 1) / KS : 0;
  return p;
}

// bfloat16: 8 warps as 2 (m) x 4 (n), each a 64 x 32 part as 4 x 4
// mma tiles; the transposing ldmatrix builds the row-major A and
// column-major B fragments from the slabs as stored. `out` is dW itself
// (one split) or the workspace of partials, (splits, 2, H, 4H).
__global__ void __launch_bounds__(kDwThreads, 2)
dw_bf16_kernel(const bf16* __restrict__ ys, const bf16* __restrict__ dx,
               float* __restrict__ out, int B, int H, int K, int rows,
               int vec) {
  constexpr int KS = kDwKBf16, LDA = kDwLdaBf16, LDB = kDwLdbBf16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const as0 = reinterpret_cast<bf16*>(smem_raw);
  bf16* const bs0 = as0 + kDwStages * KS * LDA;
  const DwSplit p = dw_split(K, rows, KS);
  const int G4 = 4 * H;
  const int m0 = blockIdx.y * kDwM;          // units of h_prev
  const int n0 = blockIdx.x * kDwN;          // gate columns
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int gq = lane >> 2, q = lane & 3;
  const int li = lane & 7, mat = lane >> 3;

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int i = 0; i < kDwStages - 1; ++i) {
    if (i < p.nslab)
      dw_stage<bf16, KS, LDA, LDB>(as0 + i * KS * LDA, bs0 + i * KS * LDB,
                                   ys, dx, p.kbeg + i * KS, p.kend, p.d, B,
                                   H, m0, n0, vec != 0);
    cp_async_commit();
  }
  for (int i = 0; i < p.nslab; ++i) {
    cp_async_wait<kDwStages - 2>();         // slab i has landed
    __syncthreads();                        // ... and slab i-1 is consumed
    const int nx = i + kDwStages - 1;
    if (nx < p.nslab) {
      const int st = nx % kDwStages;
      dw_stage<bf16, KS, LDA, LDB>(as0 + st * KS * LDA, bs0 + st * KS * LDB,
                                   ys, dx, p.kbeg + nx * KS, p.kend, p.d, B,
                                   H, m0, n0, vec != 0);
    }
    cp_async_commit();
    const bf16* As = as0 + (i % kDwStages) * KS * LDA;
    const bf16* Bs = bs0 + (i % kDwStages) * KS * LDB;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4_trans(a[mt], As + (kk + li + (mat >> 1) * 8) * LDA + wm +
                                     mt * 16 + (mat & 1) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4_trans(b[np], Bs + (kk + li + (mat & 1) * 8) * LDB + wn +
                                     np * 16 + (mat >> 1) * 8);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], a[mt][0], a[mt][1], a[mt][2], a[mt][3],
                   b[nt >> 1][(nt & 1) * 2], b[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }
  float* o = out + ((size_t)p.split * 2 + p.d) * H * G4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + mt * 16 + gq + (e >> 1) * 8;
        const int n = n0 + wn + nt * 8 + 2 * q + (e & 1);
        if (m < H && n < G4) o[(size_t)m * G4 + n] = acc[mt][nt][e];
      }
}

// float32 on wgmma in 3xTF32: the split-K frame (dw_split, the fixed-order
// sum of the partials) with the output tile as two warpgroups of 64 units
// x 128 gate columns, one m64n128k8 wgmma per tf32 product. wgmma reads
// tf32 operands K-major only, and both operands are stored k-slow, so a
// slab of kDwKF32 K rows is transposed as it is staged: each thread reads
// 16-byte runs of 4 units (A, from ys) or 4 gate columns (B, from dx) of
// one K row, splits them into tf32 hi and lo, and writes them down a
// column of the swizzled K-major planes (sw_off; the 32 threads of a warp
// take the 32 K rows of one run, so their scalar stores hit 32 banks).
// Two buffers of four planes (A hi, A lo, B hi, B lo); the next slab is
// read into registers before the current slab's wgmmas and stored while
// they run. One block an SM (128 KB of shared memory).
constexpr int kDwTile = kDwM * kDwKF32;     // floats of one plane
static_assert(kDwKF32 == kSwK && kDwM == kDwN, "dW planes: 128 x 32");

__global__ void __launch_bounds__(kDwThreads, 1)
dw_f32_kernel(const float* __restrict__ ys, const float* __restrict__ dx,
              float* __restrict__ out, int B, int H, int K, int rows,
              int vec) {
  constexpr int KS = kDwKF32;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* const sm = sw_align(smem_raw);
  const DwSplit p = dw_split(K, rows, KS);
  const int G4 = 4 * H;
  const int m0 = blockIdx.y * kDwM;
  const int n0 = blockIdx.x * kDwN;
  const int wg = threadIdx.x / 128;
  const int warp4 = (threadIdx.x / 32) & 3;
  const int lane = threadIdx.x % 32;
  const int gq = lane >> 2, q = lane & 3;
  // plane i (0 A hi, 1 A lo, 2 B hi, 3 B lo) of buffer b
  auto plane = [&](int b, int i) { return sm + (b * 4 + i) * kDwTile; };

  // run i of this thread: K row `lane` of the slab, units (i < 4: A) or
  // gate columns (B) 4 * (warp + 8 * (i % 4)) .. + 3 of the tile
  float4 v[8];
  auto load = [&](int slab) {
    const int k = p.kbeg + slab * KS + lane;
    const bool krow = k < p.kend;
    const DwRow o = krow ? dw_row(k, p.d, B, H) : DwRow{0, 0};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool is_a = i < 4;
      const int c = 4 * (threadIdx.x / 32 + 8 * (i & 3));
      const int col = (is_a ? m0 : n0) + c;
      const int W = is_a ? H : G4;
      const float* src = (is_a ? ys + o.a : dx + o.b) + col;
      if (vec) {
        v[i] = krow && col < W ? *reinterpret_cast<const float4*>(src)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        v[i] = make_float4(krow && col < W ? src[0] : 0.f,
                           krow && col + 1 < W ? src[1] : 0.f,
                           krow && col + 2 < W ? src[2] : 0.f,
                           krow && col + 3 < W ? src[3] : 0.f);
      }
    }
  };
  auto store = [&](int b) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = 4 * (threadIdx.x / 32 + 8 * (i & 3));
      float* hi = plane(b, i < 4 ? 0 : 2);
      float* lo = plane(b, i < 4 ? 1 : 3);
      const float e[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t h, l;
        split_tf32(e[j], h, l);
        const int off = sw_off(c + j, lane);
        hi[off] = __uint_as_float(h);
        lo[off] = __uint_as_float(l);
      }
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  if (p.nslab > 0) {
    load(0);
    store(0);
  }
  fence_proxy_async();
  __syncthreads();
  for (int i = 0; i < p.nslab; ++i) {
    const int b = i & 1;
    const bool more = i + 1 < p.nslab;
    if (more) load(i + 1);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KS / 8; ++j) {
      const int ao = wg * 64 * kSwK + j * 8, bo = j * 8;
      const uint64_t ah = gmma_desc(plane(b, 0) + ao);
      const uint64_t al = gmma_desc(plane(b, 1) + ao);
      const uint64_t bh = gmma_desc(plane(b, 2) + bo);
      const uint64_t bl = gmma_desc(plane(b, 3) + bo);
      wgmma_tf32_m64n128(acc, al, bh);
      wgmma_tf32_m64n128(acc, ah, bl);
      wgmma_tf32_m64n128(acc, ah, bh);
    }
    wgmma_commit();
    if (more) store(b ^ 1);                 // while the wgmmas run
    wgmma_wait<0>();
    fence_proxy_async();
    __syncthreads();
  }

  // accumulator i: unit row gq + 8*((i >> 1) & 1) of the warp's 16, gate
  // column 8*(i >> 2) + 2q + (i & 1)
  float* o = out + ((size_t)p.split * 2 + p.d) * H * G4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + wg * 64 + warp4 * 16 + gq + half * 8;
    if (m >= H) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * q;
      if (n < G4)
        *reinterpret_cast<float2*>(o + (size_t)m * G4 + n) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

// dw[i] = sum over z = 0, 1, ..., splits-1 of ws[z][i], in that order
__global__ void dw_reduce_kernel(const float4* __restrict__ ws,
                                 float4* __restrict__ dw, size_t n4,
                                 int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 s = ws[i];
    for (int z = 1; z < splits; ++z) {
      const float4 v = ws[(size_t)z * n4 + i];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    dw[i] = s;
  }
}

// ---------------------------------------------------------------------------
// the cluster kernels (K2, K3 and K4's recurrence), bfloat16
//
// A cluster of C = H / kClU blocks owns BB = 16*MT rows of one direction;
// grid (C * ceil(B / BB), 2), cluster (C, 1, 1). Block r of the cluster
// owns the kClU hidden units [r*kClU, (r+1)*kClU) and all four gates of
// them: the 4*kClU columns j + g*H of W_hh[d] (j one of its units, g a
// gate). Before step 0 it copies that slice, all H rows of it, into
// shared memory (cp.async, read from w_hh as it is), where it stays.
// Shared layouts keep a row's 4*kClU columns in the order (8-unit group,
// gate, unit in the group), so a warp's four gate tiles of one group are
// 32 neighbouring columns; rows are padded by 8 elements (16 bytes), so
// the 8 rows an ldmatrix reads fall on distinct banks.
//
// Forward: each step every block computes its columns' pre-activations
// for the tile's rows, pre = xproj[s] + h_{s-1} @ W_slice, from shared
// memory (8 warps, warp w owns group w: 4 gates x MT m16 tiles), updates
// its units' cell states, and writes its slice of h_s (bf16) into the
// next h buffer of every block of the cluster (distributed shared
// memory); one cluster barrier per step. xproj[s+1] is staged by cp.async
// while step s computes; ys is stored from shared memory in 16-byte rows.
//
// Backward: dh_{s-1} = da_s @ W_hh[d]^T reduces over all 4H columns, and
// each block holds 4*kClU of them. So each block computes da_s of its own
// (row, unit) pairs from its dh/dc carries and the residuals (bwd_cell's
// arithmetic, 16-byte loads and stores), multiplies it by its W slice
// transposed (BB x 4*kClU by 4*kClU x H, f32), and sends each peer p the
// BB x kClU f32 block of the units p owns, into slot r of p's receive
// buffer. After the cluster barrier each block sums its C slots in rank
// order, a fixed order: two launches give the same bits. Two split
// cluster barriers per step order the single receive buffer: one after
// the sends (the slots are full), one after the reads (the slots may be
// overwritten), the second's wait hidden behind the product.

constexpr int kClU = 64;                    // hidden units of a block
constexpr int kClWarps = 8;                 // one 8-unit group per warp
constexpr int kClLdw = 4 * kClU + 8;        // W slice, xproj and da rows

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// column of (unit j < kClU, gate g) in the shared layouts
__device__ __forceinline__ int cl_col(int j, int g) {
  return (j >> 3) * 32 + g * 8 + (j & 7);
}

// This block's W slice: row k, column cl_col(j, g) = w_hh[d][k][g*H + u0
// + j], for all H rows, by 16-byte cp.async (the caller commits).
__device__ __forceinline__ void cl_load_w(bf16* __restrict__ wsm,
                                          const bf16* __restrict__ w_hh,
                                          int d, int H, int u0) {
  const int G4 = 4 * H;
  for (int i = threadIdx.x; i < H * 32; i += blockDim.x) {
    const int k = i >> 5;
    const int c = i & 31;                   // chunk: group c / 4, gate c % 4
    const int g = c & 3, grp = c >> 2;
    cp_async16(wsm + k * kClLdw + grp * 32 + g * 8,
               w_hh + ((size_t)d * H + k) * G4 + g * H + u0 + grp * 8, true);
  }
}

__device__ __forceinline__ void unpack8(const uint4 v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

template <int MT, bool SAVE>
__global__ void __launch_bounds__(kClWarps * 32, 1)
fwd_cluster_kernel(const bf16* __restrict__ xproj,
                   const bf16* __restrict__ w_hh, bf16* __restrict__ ys,
                   float* __restrict__ cs, bf16* __restrict__ gates, int T_,
                   int B, int H) {
  constexpr int BB = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int d = blockIdx.y;
  const int G4 = 4 * H;
  const int u0 = rank * kClU;
  const int b0 = (blockIdx.x / C) * BB;
  const int Ldh = H + 8;
  bf16* const wsm = reinterpret_cast<bf16*>(smem_raw);   // H x kClLdw
  bf16* const hbuf0 = wsm + (size_t)H * kClLdw;          // BB x Ldh, twice
  bf16* const hbuf1 = hbuf0 + BB * Ldh;
  bf16* const xs = hbuf1 + BB * Ldh;                     // BB x kClLdw
  const int warp = threadIdx.x / 32;                     // = its group
  const int lane = threadIdx.x % 32;
  const int gq = lane >> 2, q = lane & 3;
  const int li = lane & 7, mat = lane >> 3;

  // xproj[s] of this block's columns and the tile's rows into xs; rows
  // >= B read zeros
  auto stage_x = [&](int s) {
    const size_t step = (size_t)s * 2 + d;
    for (int i = threadIdx.x; i < BB * 32; i += blockDim.x) {
      const int r = i >> 5;
      const int c = i & 31;
      const int g = c & 3, grp = c >> 2;
      const int row = b0 + r;
      const bool ok = row < B;
      const bf16* src = ok ? xproj + (step * B + row) * G4 + g * H + u0 +
                                 grp * 8
                           : xproj;
      cp_async16(xs + r * kClLdw + grp * 32 + g * 8, src, ok);
    }
  };

  cl_load_w(wsm, w_hh, d, H, u0);
  stage_x(0);
  cp_async_commit();
  for (int i = threadIdx.x; i < BB * Ldh / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(hbuf0)[i] = make_uint4(0, 0, 0, 0);  // h_{-1}
  // the same h buffers in every block of the cluster
  bf16* peer0[4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
    peer0[p] = p < C ? cluster.map_shared_rank(hbuf0, p) : hbuf0;
  cp_async_wait<0>();
  cluster_arrive();                         // every peer runs, W is in place
  cluster_wait();

  float c[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[mt][e] = 0.f;
  const int jl = warp * 8 + 2 * q;          // this thread's units jl, jl+1

  for (int s = 0; s < T_; ++s) {
    const bool last = s + 1 == T_;
    const bf16* cur = s & 1 ? hbuf1 : hbuf0;
    const int nxt_off = (s & 1 ? 0 : BB * Ldh);   // of the next buffer
    const size_t step = (size_t)s * 2 + d;

    float acc[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = mt * 16 + gq + half * 8;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  xs + r * kClLdw + cl_col(jl, g)));
          acc[mt][g][2 * half] = v.x;
          acc[mt][g][2 * half + 1] = v.y;
        }
      }
    __syncthreads();                        // every thread has read xs
    if (!last) stage_x(s + 1);
    cp_async_commit();

#pragma unroll 4
    for (int kk = 0; kk < H; kk += 16) {
      uint32_t b[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4_trans(b[np], wsm + (kk + li + (mat & 1) * 8) * kClLdw +
                                     warp * 32 + np * 16 + (mat >> 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, cur + (mt * 16 + li + (mat & 1) * 8) * Ldh + kk +
                           (mat >> 1) * 8);
#pragma unroll
        for (int g = 0; g < 4; ++g)
          mma_bf16(acc[mt][g], a[0], a[1], a[2], a[3],
                   b[g >> 1][(g & 1) * 2], b[g >> 1][(g & 1) * 2 + 1]);
      }
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float gv[4][2], h[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int e = 2 * half + k;
          gv[0][k] = sigmoid_f(acc[mt][0][e]);
          gv[1][k] = sigmoid_f(acc[mt][1][e]);
          gv[2][k] = tanhf(acc[mt][2][e]);
          gv[3][k] = sigmoid_f(acc[mt][3][e]);
          c[mt][e] = gv[1][k] * c[mt][e] + gv[0][k] * gv[2][k];
          h[k] = gv[3][k] * tanhf(c[mt][e]);
        }
        const int r = mt * 16 + gq + half * 8;
        const __nv_bfloat162 hv = __floats2bfloat162_rn(h[0], h[1]);
        const int off = nxt_off + r * Ldh + u0 + jl;
        if (last) {
          *reinterpret_cast<__nv_bfloat162*>(hbuf0 + off) = hv;
        } else {
#pragma unroll
          for (int p = 0; p < 4; ++p)
            if (p < C) *reinterpret_cast<__nv_bfloat162*>(peer0[p] + off) = hv;
        }
        const int row = b0 + r;
        if (SAVE && row < B) {
          const size_t hi = (step * B + row) * H + u0 + jl;
          *reinterpret_cast<float2*>(cs + hi) =
              make_float2(c[mt][2 * half], c[mt][2 * half + 1]);
          bf16* gr = gates + (step * B + row) * G4 + u0 + jl;
#pragma unroll
          for (int g = 0; g < 4; ++g)
            *reinterpret_cast<__nv_bfloat162*>(gr + g * H) =
                __floats2bfloat162_rn(gv[g][0], gv[g][1]);
        }
      }
    cp_async_wait<0>();                     // xproj[s+1] is in xs
    if (last) {
      __syncthreads();
    } else {
      cluster_arrive();                     // h_s is in every block's buffer
      cluster_wait();
    }
    // ys[s] of this block's units, from its own copy of h_s
    const bf16* hs = hbuf0 + nxt_off;
    for (int i = threadIdx.x; i < BB * (kClU / 8); i += blockDim.x) {
      const int r = i / (kClU / 8);
      const int j = (i % (kClU / 8)) * 8;
      if (b0 + r < B)
        *reinterpret_cast<uint4*>(ys + (step * B + b0 + r) * H + u0 + j) =
            *reinterpret_cast<const uint4*>(hs + r * Ldh + u0 + j);
    }
  }
}

// The residuals of one (row, 8-unit chunk) pair for one step: the four
// activated gates, dy, and c_{s-1} (the next step's c_t).
struct ClRes {
  uint4 g[4];
  uint4 dy;
  float4 cp[2];
};

__device__ __forceinline__ ClRes cl_load_res(const bf16* __restrict__ dys,
                                             const float* __restrict__ cs,
                                             const bf16* __restrict__ gates,
                                             int s, int d, int B, int H,
                                             int row, int u) {
  ClRes res;
  const size_t step = (size_t)s * 2 + d;
  const bf16* gr = gates + (step * B + row) * (size_t)(4 * H) + u;
#pragma unroll
  for (int g = 0; g < 4; ++g)
    res.g[g] = *reinterpret_cast<const uint4*>(gr + g * H);
  res.dy = *reinterpret_cast<const uint4*>(dys + (step * B + row) * H + u);
  if (s > 0) {
    const float4* cp = reinterpret_cast<const float4*>(
        cs + ((step - 2) * B + row) * H + u);
    res.cp[0] = cp[0];
    res.cp[1] = cp[1];
  } else {
    res.cp[0] = res.cp[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  return res;
}

// MT: m16 tiles of the row tile; NT = C: n8 tiles of dh per warp (warp w
// owns the 8*NT units from w*8*NT, all of one peer's 64)
template <int MT, int NT>
__global__ void __launch_bounds__(kClWarps * 32, 1)
bwd_cluster_kernel(const bf16* __restrict__ dys, const float* __restrict__ cs,
                   const bf16* __restrict__ gates,
                   const bf16* __restrict__ w_hh, bf16* __restrict__ dx,
                   int T_, int B) {
  constexpr int BB = 16 * MT;
  constexpr int C = NT;
  constexpr int H = kClU * C;
  constexpr int G4 = 4 * H;
  constexpr int NCH = BB * (kClU / 8);      // (row, 8-unit chunk) pairs
  constexpr int CPT = (NCH + kClWarps * 32 - 1) / (kClWarps * 32);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int d = blockIdx.y;
  const int u0 = rank * kClU;
  const int b0 = (blockIdx.x / C) * BB;
  bf16* const wsm = reinterpret_cast<bf16*>(smem_raw);   // H x kClLdw
  bf16* const das = wsm + (size_t)H * kClLdw;            // BB x kClLdw
  float* const recv = reinterpret_cast<float*>(das + BB * kClLdw);
  // recv[slot][row][unit]: C slots of BB x kClU
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane >> 2, q = lane & 3;
  const int li = lane & 7, mat = lane >> 3;
  const int n0 = warp * 8 * NT;             // this warp's first unit of dh
  // slot `rank` of the receive buffer of the peer that owns unit n0
  float* const dst = cluster.map_shared_rank(recv, n0 / kClU) +
                     rank * BB * kClU + n0 % kClU;

  cl_load_w(wsm, w_hh, d, H, u0);
  cp_async_commit();

  float dc[CPT][8], c_t[CPT][8];
  ClRes res[CPT];
#pragma unroll
  for (int ci = 0; ci < CPT; ++ci) {
    const int i = threadIdx.x + ci * kClWarps * 32;
    const int row = b0 + i / (kClU / 8);
    const int u = u0 + (i % (kClU / 8)) * 8;
#pragma unroll
    for (int k = 0; k < 8; ++k) dc[ci][k] = 0.f;
    if (i < NCH && row < B) {
      res[ci] = cl_load_res(dys, cs, gates, T_ - 1, d, B, H, row, u);
      const float4* ct = reinterpret_cast<const float4*>(
          cs + (((size_t)(T_ - 1) * 2 + d) * B + row) * H + u);
      const float4 c0 = ct[0], c1 = ct[1];
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) c_t[ci][k] = cv[k];
    }
  }
  cp_async_wait<0>();
  cluster_arrive();                         // every peer runs, W is in place
  cluster_wait();

  for (int s = T_ - 1; s >= 0; --s) {
    const size_t step = (size_t)s * 2 + d;
    if (s < T_ - 1) cluster_wait();         // the slots hold dh_s's parts
#pragma unroll
    for (int ci = 0; ci < CPT; ++ci) {
      const int i = threadIdx.x + ci * kClWarps * 32;
      if (i >= NCH) break;
      const int r = i / (kClU / 8);
      const int j = (i % (kClU / 8)) * 8;   // first unit, block-local
      const int row = b0 + r;
      float da[4][8];
      if (row < B) {
        float dh[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) dh[k] = 0.f;
        if (s < T_ - 1) {
          for (int p = 0; p < C; ++p) {     // rank order: deterministic
            const float4* src = reinterpret_cast<const float4*>(
                recv + (p * BB + r) * kClU + j);
            const float4 a = src[0], b = src[1];
            dh[0] += a.x; dh[1] += a.y; dh[2] += a.z; dh[3] += a.w;
            dh[4] += b.x; dh[5] += b.y; dh[6] += b.z; dh[7] += b.w;
          }
        }
        float gv[4][8], dy[8];
#pragma unroll
        for (int g = 0; g < 4; ++g) unpack8(res[ci].g[g], gv[g]);
        unpack8(res[ci].dy, dy);
        const float cpv[8] = {res[ci].cp[0].x, res[ci].cp[0].y,
                              res[ci].cp[0].z, res[ci].cp[0].w,
                              res[ci].cp[1].x, res[ci].cp[1].y,
                              res[ci].cp[1].z, res[ci].cp[1].w};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float ig = gv[0][k], fg = gv[1][k], gg = gv[2][k],
                      og = gv[3][k];
          const float tanh_c = tanhf(c_t[ci][k]);
          const float dh_t = dy[k] + dh[k];
          const float dc_t =
              dc[ci][k] + dh_t * og * (1.f - tanh_c * tanh_c);
          da[0][k] = dc_t * gg * ig * (1.f - ig);
          da[1][k] = dc_t * cpv[k] * fg * (1.f - fg);
          da[2][k] = dc_t * ig * (1.f - gg * gg);
          da[3][k] = dh_t * tanh_c * og * (1.f - og);
          dc[ci][k] = dc_t * fg;
          c_t[ci][k] = cpv[k];              // c_t of step s-1
        }
        bf16* dxr = dx + (step * B + row) * G4 + u0 + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const uint4 v = pack8(da[g]);     // the stored, rounded da
          *reinterpret_cast<uint4*>(dxr + g * H) = v;
          *reinterpret_cast<uint4*>(das + r * kClLdw + cl_col(j, g)) = v;
        }
        if (s > 0)                          // next step's residuals, early
          res[ci] = cl_load_res(dys, cs, gates, s - 1, d, B, H, row, u0 + j);
      } else {                              // rows past the edge: da = 0
#pragma unroll
        for (int g = 0; g < 4; ++g)
          *reinterpret_cast<uint4*>(das + r * kClLdw + cl_col(j, g)) =
              make_uint4(0, 0, 0, 0);
      }
    }
    if (s == 0) break;                      // dh_{-1} is not needed
    cluster_arrive();                       // this block's slots are read
    __syncthreads();                        // da_s of every unit is in das

    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < 4 * kClU; kk += 16) {
      uint32_t b[NT / 2][4];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        ldmatrix_x4(b[np], wsm + (n0 + np * 16 + li + (mat >> 1) * 8) *
                                     kClLdw + kk + (mat & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, das + (mt * 16 + li + (mat & 1) * 8) * kClLdw + kk +
                           (mat >> 1) * 8);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16(acc[mt][nt], a[0], a[1], a[2], a[3],
                   b[nt >> 1][(nt & 1) * 2], b[nt >> 1][(nt & 1) * 2 + 1]);
      }
    }
    cluster_wait();                         // every peer has read its slots
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = mt * 16 + gq + half * 8;
          *reinterpret_cast<float2*>(dst + r * kClU + nt * 8 + 2 * q) =
              make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
        }
    cluster_arrive();                       // the slots hold dh_{s-1}'s parts
  }
}

// ---------------------------------------------------------------------------
// the cluster kernels (K2, K3 and K4's recurrence), float32
//
// The bfloat16 cluster design at float32 storage. A block's W slice costs
// twice the bytes, so a block owns kClUF = 32 hidden units (4*32 columns
// of W_hh[d]) and a cluster holds C = H / 32 blocks: 4 at H = 128, 8 at
// H = 256. The per-step products run on the tensor cores in 3xTF32
// (mma.sync m16n8k8): each f32 operand is split as x = hi + lo, both
// rounded to tf32, and hi*hi + hi*lo + lo*hi is summed into the f32
// accumulator (lo*lo, about 2^-22 of a product, is dropped), which keeps
// about f32's
// accuracy at three tensor-core products per product. W is split as it
// is read from shared memory (pre-split copies would double its bytes),
// h (forward) and da (backward) likewise.
//
// Forward: W slice in shared memory with rows of kClLdwF = 136 floats
// (column order: 8-unit group, gate, unit in the group) and one h buffer
// (rows of H + 4 floats), so that a row tile of 80 fits a block at H=256
// and the grid fits the card in one wave (the H100 holds 15 clusters of
// 8). Two cluster barriers per step: the first's arrive after the
// product (h_{s-1} read), its wait after the cell update, before h_s goes
// to every peer's buffer; the second after those writes. xproj[s+1] is
// read into registers while step s computes; ys, cs and the gates are
// stored from registers. Warp w owns 8-unit group w % 4 and m16 tiles
// w / 4, w / 4 + 2, ...: a thread's accumulators hold i, f, g and o of
// the same (row, unit) pairs.
// Backward: as the bfloat16 kernel, with f32 da (no rounding: the storage
// type is f32), rows of kClLdaF = 132 floats, a (row, 4-unit chunk) pair
// per thread, and C receive slots of rows x 32 f32; the slots are summed
// in rank order, so two launches give the same bits.
// The row strides make every fragment load conflict-free: a B fragment of
// the forward reads rows q and columns gq (stride 136 = 8 mod 32 banks),
// every other fragment rows gq and columns q (stride 4 mod 32 banks).

constexpr int kClUF = 32;                   // hidden units of a block
constexpr int kClLdwF = 4 * kClUF + 8;      // forward W slice rows
constexpr int kClLdaF = 4 * kClUF + 4;      // backward W slice and da rows
constexpr int kClMaxC = 8;                  // the largest cluster (H = 256)

// ys_b and mode: ys_row (SAVE only with kYsSteps).
template <int MT, bool SAVE>
__global__ void __launch_bounds__(kClWarps * 32, 1)
fwd_cluster_f32_kernel(const float* __restrict__ xproj,
                       const float* __restrict__ w_hh, float* __restrict__ ys,
                       float* __restrict__ ys_b, float* __restrict__ cs,
                       float* __restrict__ gates, int T_, int B, int H,
                       int mode) {
  constexpr int BB = 16 * MT;
  constexpr int MW = (MT + 1) / 2;          // m16 tiles of a warp, at most
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int d = blockIdx.y;
  const int G4 = 4 * H;
  const int u0 = rank * kClUF;
  const int b0 = ((int)blockIdx.x / C) * BB;
  const int Ldh = H + 4;
  float* const wsm = reinterpret_cast<float*>(smem_raw);  // H x kClLdwF
  float* const hbuf = wsm + (size_t)H * kClLdwF;          // BB x Ldh
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane >> 2, q = lane & 3;
  const int grp = warp & 3;                 // the warp's 8-unit group
  const int mt0 = warp >> 2;                // its m16 tiles mt0, mt0 + 2, ..
  const int jl = grp * 8 + 2 * q;           // this thread's units jl, jl+1

  // row k, column grp*32 + g*8 + j of the slice = w_hh[d][k][g*H + u0 +
  // grp*8 + j], by 16-byte cp.async
  for (int i = threadIdx.x; i < H * 32; i += blockDim.x) {
    const int k = i >> 5, c = i & 31;
    const int gp = c >> 3, g = (c >> 1) & 3, half = c & 1;
    cp_async16(wsm + k * kClLdwF + gp * 32 + g * 8 + half * 4,
               w_hh + ((size_t)d * H + k) * G4 + g * H + u0 + gp * 8 +
                   half * 4,
               true);
  }
  cp_async_commit();

  // xproj[s] of this thread's (row, unit) pairs, in the accumulator
  // layout; rows >= B read zeros
  float xn[MW][4][4];
  auto load_x = [&](int s) {
    const size_t step = (size_t)s * 2 + d;
#pragma unroll
    for (int mw = 0; mw < MW; ++mw)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = b0 + (mt0 + 2 * mw) * 16 + gq + half * 8;
        const bool ok = mt0 + 2 * mw < MT && row < B;
        const float* xr = xproj + (step * B + row) * G4 + u0 + jl;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float2 v = ok ? *reinterpret_cast<const float2*>(xr + g * H)
                              : make_float2(0.f, 0.f);
          xn[mw][g][2 * half] = v.x;
          xn[mw][g][2 * half + 1] = v.y;
        }
      }
  };
  load_x(0);
  for (int i = threadIdx.x; i < BB * Ldh / 4; i += blockDim.x)
    reinterpret_cast<float4*>(hbuf)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  // the same h buffer in every block of the cluster
  float* peer[kClMaxC];
#pragma unroll
  for (int p = 0; p < kClMaxC; ++p)
    peer[p] = p < C ? cluster.map_shared_rank(hbuf, p) : hbuf;
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
    const size_t step = (size_t)s * 2 + d;

    float acc[MW][4][4];
#pragma unroll
    for (int mw = 0; mw < MW; ++mw)
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mw][g][e] = xn[mw][g][e];
    if (!last) load_x(s + 1);               // in flight during the product

#pragma unroll 2
    for (int kk = 0; kk < H; kk += 8) {
      uint32_t bh[4][2], bl[4][2];
      const float* wp = wsm + (kk + q) * kClLdwF + grp * 32 + gq;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        split_tf32(wp[g * 8], bh[g][0], bl[g][0]);
        split_tf32(wp[4 * kClLdwF + g * 8], bh[g][1], bl[g][1]);
      }
#pragma unroll
      for (int mw = 0; mw < MW; ++mw) {
        if (mt0 + 2 * mw >= MT) break;      // the same for the whole warp
        uint32_t ah[4], al[4];
        a_frag_f32(hbuf + ((mt0 + 2 * mw) * 16 + gq) * Ldh + kk + q, Ldh,
                   ah, al);
#pragma unroll
        for (int g = 0; g < 4; ++g)
          mma_3xtf32(acc[mw][g], ah, al, bh[g], bl[g]);
      }
    }
    if (!last) cluster_arrive();            // this block read h_{s-1}

    float2 hv[MW][2];
#pragma unroll
    for (int mw = 0; mw < MW; ++mw) {
      if (mt0 + 2 * mw >= MT) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float gv[4][2], h[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int e = 2 * half + k;
          gv[0][k] = sigmoid_f(acc[mw][0][e]);
          gv[1][k] = sigmoid_f(acc[mw][1][e]);
          gv[2][k] = tanhf(acc[mw][2][e]);
          gv[3][k] = sigmoid_f(acc[mw][3][e]);
          c[mw][e] = gv[1][k] * c[mw][e] + gv[0][k] * gv[2][k];
          h[k] = gv[3][k] * tanhf(c[mw][e]);
        }
        hv[mw][half] = make_float2(h[0], h[1]);
        const int row = b0 + (mt0 + 2 * mw) * 16 + gq + half * 8;
        if (row < B) {
          const size_t hi = (step * B + row) * H + u0 + jl;
          float* yr = ys_row(ys, ys_b, mode, s, d, T_, B, H, row);
          if (yr != nullptr)
            *reinterpret_cast<float2*>(yr + u0 + jl) = hv[mw][half];
          if (SAVE) {
            *reinterpret_cast<float2*>(cs + hi) =
                make_float2(c[mw][2 * half], c[mw][2 * half + 1]);
            float* gr = gates + (step * B + row) * G4 + u0 + jl;
#pragma unroll
            for (int g = 0; g < 4; ++g)
              *reinterpret_cast<float2*>(gr + g * H) =
                  make_float2(gv[g][0], gv[g][1]);
          }
        }
      }
    }
    if (last) break;                        // h_{T-1} feeds no product
    cluster_wait();                         // every peer read its h_{s-1}
#pragma unroll
    for (int mw = 0; mw < MW; ++mw) {
      if (mt0 + 2 * mw >= MT) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int off = ((mt0 + 2 * mw) * 16 + gq + half * 8) * Ldh + u0 + jl;
#pragma unroll
        for (int p = 0; p < kClMaxC; ++p)
          if (p < C) *reinterpret_cast<float2*>(peer[p] + off) = hv[mw][half];
      }
    }
    cluster_arrive();                       // h_s is in every block's buffer
    cluster_wait();
  }
}

// The residuals of one (row, 4-unit chunk) pair for one step: the four
// activated gates, dy, and c_{s-1} (the next step's c_t).
struct ClResF {
  float4 g[4];
  float4 dy;
  float4 cp;
};

__device__ __forceinline__ ClResF cl_load_res_f32(
    const float* __restrict__ dys, const float* __restrict__ cs,
    const float* __restrict__ gates, int s, int d, int B, int H, int row,
    int u) {
  ClResF res;
  const size_t step = (size_t)s * 2 + d;
  const float* gr = gates + (step * B + row) * (size_t)(4 * H) + u;
#pragma unroll
  for (int g = 0; g < 4; ++g)
    res.g[g] = *reinterpret_cast<const float4*>(gr + g * H);
  res.dy = *reinterpret_cast<const float4*>(dys + (step * B + row) * H + u);
  res.cp = s > 0 ? *reinterpret_cast<const float4*>(
                       cs + ((step - 2) * B + row) * H + u)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  return res;
}

__device__ __forceinline__ void f4_to(const float4 v, float (&f)[4]) {
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

// MT: m16 tiles of the row tile; C: the cluster (H = 32 * C). Warp w
// computes dh for the NT = H/64 n8 tiles of units from w*8*NT, all of one
// peer's 32.
template <int MT, int C>
__global__ void __launch_bounds__(kClWarps * 32, 1)
bwd_cluster_f32_kernel(const float* __restrict__ dys,
                       const float* __restrict__ cs,
                       const float* __restrict__ gates,
                       const float* __restrict__ w_hh, float* __restrict__ dx,
                       int T_, int B) {
  constexpr int BB = 16 * MT;
  constexpr int H = kClUF * C;
  constexpr int G4 = 4 * H;
  constexpr int NT = H / (8 * kClWarps);
  constexpr int NCH = BB * (kClUF / 4);     // (row, 4-unit chunk) pairs
  constexpr int CPT = (NCH + kClWarps * 32 - 1) / (kClWarps * 32);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int d = blockIdx.y;
  const int u0 = rank * kClUF;
  const int b0 = (blockIdx.x / C) * BB;
  float* const wsm = reinterpret_cast<float*>(smem_raw);  // H x kClLdaF
  float* const das = wsm + (size_t)H * kClLdaF;           // BB x kClLdaF
  float* const recv = das + BB * kClLdaF;
  // recv[slot][row][unit]: C slots of BB x kClUF
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane >> 2, q = lane & 3;
  const int n0 = warp * 8 * NT;             // this warp's first unit of dh
  // slot `rank` of the receive buffer of the peer that owns unit n0
  float* const dst = cluster.map_shared_rank(recv, n0 / kClUF) +
                     rank * BB * kClUF + n0 % kClUF;

  // row k, column g*32 + j of the slice = w_hh[d][k][g*H + u0 + j]
  for (int i = threadIdx.x; i < H * 32; i += blockDim.x) {
    const int k = i >> 5, c = i & 31;
    cp_async16(wsm + k * kClLdaF + c * 4,
               w_hh + ((size_t)d * H + k) * G4 + (c >> 3) * H + u0 +
                   (c & 7) * 4,
               true);
  }
  cp_async_commit();

  float dc[CPT][4], c_t[CPT][4];
  ClResF res[CPT];
#pragma unroll
  for (int ci = 0; ci < CPT; ++ci) {
    const int i = threadIdx.x + ci * kClWarps * 32;
    const int row = b0 + i / (kClUF / 4);
    const int u = u0 + (i % (kClUF / 4)) * 4;
#pragma unroll
    for (int k = 0; k < 4; ++k) dc[ci][k] = c_t[ci][k] = 0.f;
    if (i < NCH && row < B) {
      res[ci] = cl_load_res_f32(dys, cs, gates, T_ - 1, d, B, H, row, u);
      f4_to(*reinterpret_cast<const float4*>(
                cs + (((size_t)(T_ - 1) * 2 + d) * B + row) * H + u),
            c_t[ci]);
    }
  }
  cp_async_wait<0>();
  cluster_arrive();                         // every peer runs, W is in place
  cluster_wait();

  for (int s = T_ - 1; s >= 0; --s) {
    const size_t step = (size_t)s * 2 + d;
    if (s < T_ - 1) cluster_wait();         // the slots hold dh_s's parts
#pragma unroll
    for (int ci = 0; ci < CPT; ++ci) {
      const int i = threadIdx.x + ci * kClWarps * 32;
      if (i >= NCH) break;
      const int r = i / (kClUF / 4);
      const int j = (i % (kClUF / 4)) * 4;  // first unit, block-local
      const int row = b0 + r;
      float da[4][4];
      if (row < B) {
        float dh[4] = {0.f, 0.f, 0.f, 0.f};
        if (s < T_ - 1) {
          for (int p = 0; p < C; ++p) {     // rank order: deterministic
            const float4 a = *reinterpret_cast<const float4*>(
                recv + (p * BB + r) * kClUF + j);
            dh[0] += a.x; dh[1] += a.y; dh[2] += a.z; dh[3] += a.w;
          }
        }
        float gv[4][4], dy[4], cpv[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) f4_to(res[ci].g[g], gv[g]);
        f4_to(res[ci].dy, dy);
        f4_to(res[ci].cp, cpv);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float ig = gv[0][k], fg = gv[1][k], gg = gv[2][k],
                      og = gv[3][k];
          const float tanh_c = tanhf(c_t[ci][k]);
          const float dh_t = dy[k] + dh[k];
          const float dc_t =
              dc[ci][k] + dh_t * og * (1.f - tanh_c * tanh_c);
          da[0][k] = dc_t * gg * ig * (1.f - ig);
          da[1][k] = dc_t * cpv[k] * fg * (1.f - fg);
          da[2][k] = dc_t * ig * (1.f - gg * gg);
          da[3][k] = dh_t * tanh_c * og * (1.f - og);
          dc[ci][k] = dc_t * fg;
          c_t[ci][k] = cpv[k];              // c_t of step s-1
        }
        float* dxr = dx + (step * B + row) * G4 + u0 + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float4 v = make_float4(da[g][0], da[g][1], da[g][2], da[g][3]);
          *reinterpret_cast<float4*>(dxr + g * H) = v;
          *reinterpret_cast<float4*>(das + r * kClLdaF + g * 32 + j) = v;
        }
        if (s > 0)                          // next step's residuals, early
          res[ci] = cl_load_res_f32(dys, cs, gates, s - 1, d, B, H, row,
                                    u0 + j);
      } else {                              // rows past the edge: da = 0
#pragma unroll
        for (int g = 0; g < 4; ++g)
          *reinterpret_cast<float4*>(das + r * kClLdaF + g * 32 + j) =
              make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    if (s == 0) break;                      // dh_{-1} is not needed
    cluster_arrive();                       // this block's slots are read
    __syncthreads();                        // da_s of every unit is in das

    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < 4 * kClUF; kk += 8) {
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* wp = wsm + (n0 + nt * 8 + gq) * kClLdaF + kk + q;
        split_tf32(wp[0], bh[nt][0], bl[nt][0]);
        split_tf32(wp[4], bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t ah[4], al[4];
        a_frag_f32(das + (mt * 16 + gq) * kClLdaF + kk + q, kClLdaF, ah, al);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_3xtf32(acc[mt][nt], ah, al, bh[nt], bl[nt]);
      }
    }
    cluster_wait();                         // every peer has read its slots
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = mt * 16 + gq + half * 8;
          *reinterpret_cast<float2*>(dst + r * kClUF + nt * 8 + 2 * q) =
              make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
        }
    cluster_arrive();                       // the slots hold dh_{s-1}'s parts
  }
}

// ---------------------------------------------------------------------------
// K1's float32 recurrence on wgmma: W_hh streamed by TMA in tf32 hi and lo
// planes to 64-row blocks (call_mods' forward tiles;
// ops/recurrence.py::k1_rec_plan picks it or the cluster kernel above)
//
// Replaces, with fused_bilstm.cu's projection kernel before it, the
// recurrence of deepsignal_plant_tpu/ops/pallas_fused.py::_fused_kernel
// at float32: h_{s-1} @ W_hh[d] added to xproj[s, d] (the projection with
// the bias), then the cell update, for T steps; h stored as K1 stores it
// (ys_row's kYsTrueTime or kYsFinal).
//
// What bounds it: a comb layer at 4,096 rows is 2 * 2 * T * B * H * 4H =
// 56 GFLOP of f32 products at H = 256, 167 GFLOP in 3xTF32 (0.34 ms at
// 495 TFLOP/s), against xproj read (0.44 GB) and h written (0.11 GB):
// 0.16 ms at 3.35 TB/s. Operations bind, in 13 dependent steps. The
// cluster kernel above keeps a 32-unit W_hh slice resident in each block
// of a cluster of 8 (139 KB at H = 256), so its row tile stops at 64-80
// rows and a 4,096-row tile takes about 9 waves of 13 steps; each step
// pays two cluster barriers, h written into 8 peers, every W and h
// fragment split into tf32 hi and lo in registers, and mma.sync, which
// does not reach wgmma's rate on Hopper.
//
// Design, after fused_bilstm.cu's bfloat16 wgmma kernel:
// - A block owns 64 rows (one wgmma M tile) of one direction for all T
//   steps; a cluster of C (1, 2 or 4) blocks owns neighbouring row tiles
//   of the same direction: grid (round_up(ceil(B / 64), C), 2), at 4,096
//   rows 128 blocks, one wave.
// - W_hh[d] is packed once per model (ops/fused_lstm.py::
//   pack_rec_weights) in the order the kernel streams it: per chunk cc
//   and 16-float K slab kb, one stage of 32 KB holding each consumer
//   warpgroup's 128 x 16 tile twice, as tf32 hi and lo (tf32_split), each
//   the 64-byte swizzled K-major image wgmma reads. Packed column 32 * ug +
//   8 * gate + e of warpgroup w's chunk cc is gate `gate` of unit 32 * (w *
//   NCH + cc) + 8 * ug + e, so a thread's accumulators hold i, f, g and o
//   of the same (row, unit) pairs. W is never split in the loop.
// - A producer warpgroup (warps 8-11; one thread works, the others give
//   their registers to the consumers by setmaxnreg) keeps a ring of 2-6
//   stages full: block 0 of the cluster copies each stage with one TMA
//   bulk copy multicast to the cluster; a stage is refilled once all 8
//   consumer warps of every block have released it (arrivals on every
//   block's `empty` mbarrier, through DSMEM). The stream does not depend
//   on h, so the producer runs ahead across steps. (Prefetching each
//   block's rows of xproj[s + 1] into L2 as step s started made the
//   4,096-row tiles 5-13% slower on the H100.)
// - Two consumer warpgroups own H / 2 units each, in NCH = H / 64 chunks
//   of 32 units (m64n128 accumulators, 64 registers a thread). A chunk's
//   accumulators start from xproj[s], loaded as the previous chunk's
//   cell update frees them, and take 3xTF32 products on wgmma m64n128k8:
//   lo*hi + hi*lo + hi*hi, lo*lo dropped, as the projection kernel runs
//   its own. c stays in f32 registers for all T steps; sigmoid and tanh
//   come from __expf and __fdividef (f32, a few ulp).
// - h_{s-1} lives once, in f32 (64 x H, in slabs of 32 floats in the
//   128-byte swizzle). Its hi is that plane itself, through a descriptor:
//   the tensor cores read a .tf32 operand's top 19 bits, so hi is h
//   truncated to tf32. Its lo, h - hi (exact in f32, rounded to tf32 by
//   the half ulp split_tf32 adds), is made in registers from the same
//   plane for the register-operand wgmma, each k8 fragment once a chunk.
//   Splitting h once a step into hi and lo planes instead (128 KB) left
//   room for 3 ring stages, not 5, and was slower on the H100 (PERF.md).
//   Every chunk of both warpgroups reads all of h_{s-1}, so h_s is held
//   in registers until the last chunk's products are done (a named
//   barrier of the 256 consumer threads), then stored, fenced for the
//   async proxy, and a second named barrier ends the step. No cluster
//   barrier in the loop: h never leaves the block.
// Shared memory at H = 256: the h plane 64 KB and 5 stages of 32 KB (225
// KB with the barriers and 1,024 bytes of alignment); at H = 128 32 KB
// and 4 stages (ops/recurrence.py::K1W_STAGES: more were slower there).

namespace k1_rec {

constexpr int kRows = 64;                 // rows of a block
constexpr int kKs = 16;                   // K of a stage: 64-byte rows
constexpr int kTile = 128 * kKs;          // floats of one plane tile
constexpr int kStageF = 4 * kTile;        // floats of a stage (2 wg x hi, lo)
constexpr int kStage = kStageF * 4;       // bytes of a stage: 32 KB
constexpr int kSlab = kRows * kSwK;       // floats of an h slab (64 x 32)
constexpr int kConsumers = 256;           // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kMaxStages = 6;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;   // setmaxnreg
static_assert(kConsumers * kConsumerRegs + 128 * kProducerRegs <= 65536,
              "the register file of an SM");

// d (64 x 128 f32, the m64n128 accumulator layout) += a @ b (8 x 128), a
// the 64 x 8 tf32 fragment in registers (a warp's 16 rows: rows gq and gq
// + 8 by columns q and q + 4, as mma.m16n8k8's A), b a descriptor.
// Asynchronous, as wgmma_tf32_m64n128.
__device__ __forceinline__ void wgmma_tf32_m64n128_ra(float (&d)[64],
                                                      const uint32_t (&a)[4],
                                                      uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}"
      ", {%64,%65,%66,%67}, %68, 1, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// the tf32 lo of x against the tensor cores' truncation of x to tf32 (its
// hi): x - hi, exact in f32, with the half ulp that rounds it (split_tf32)
__device__ __forceinline__ uint32_t lo_of(float x) {
  const float hi = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
  return __float_as_uint(x - hi) + 0x1000u;
}

// shared memory without the ring: the h plane, the barriers, alignment
inline size_t fixed_smem(int H) {
  return (size_t)kRows * H * sizeof(float) +
         2 * kMaxStages * sizeof(uint64_t) + 1024;
}

// NCH: chunks of 32 units a warpgroup (H = 64 * NCH); ys_b and mode:
// ys_row (kYsTrueTime or kYsFinal)
template <int NCH>
__global__ void __launch_bounds__(kThreads, 1)
fwd_f32_kernel(const float* __restrict__ xproj, const float* __restrict__ wp,
               float* __restrict__ ys_f, float* __restrict__ ys_b, int T_,
               int B, int stages, int mode) {
  constexpr int H = 64 * NCH;
  constexpr int G4 = 4 * H;
  constexpr int NKS = H / kKs;              // stages of a chunk
  constexpr int NST = NCH * NKS;            // stages of a step
  static_assert(NKS % 2 == 0, "stages go in pairs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // (sw_align: the ring and h on 1,024 bytes; fixed_smem leaves room)
  float* const ring = sw_align(smem_raw);
  float* const hs = ring + stages * kStageF;                // h_{s-1}
  uint64_t* const bars = reinterpret_cast<uint64_t*>(hs + kRows * H);
  const uint32_t full0 = smem_u32(bars);                // full[i]: +8i
  const uint32_t empty0 = smem_u32(bars + kMaxStages);  // empty[i]: +8i
  const int d = blockIdx.y;
  const int b0 = blockIdx.x * kRows;
  const uint32_t C = cluster_blocks();
  const uint32_t rank = cluster_rank();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 8 * C);     // 8 consumer warps a block
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (warp < 8) {
    // h_{-1} = 0
    for (int i = threadIdx.x; i < kRows * H / 4; i += kConsumers)
      reinterpret_cast<float4*>(hs)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    fence_proxy_async();
  }
  cluster_sync_all();    // every block's barriers set up, h_{-1} in place

  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (warp == 8 && lane == 0) {
      const uint16_t mask = (uint16_t)((1u << C) - 1);
      const float* wd = wp + (size_t)d * NST * kStageF;
      int slot = 0;
      uint32_t phase = 0;
      for (int s = 0; s < T_; ++s) {
        for (int i = 0; i < NST; ++i) {
          // the slot's previous use is released (a fresh barrier passes
          // a wait on parity 1 at once)
          mbar_wait(empty0 + 8 * slot, phase ^ 1);
          const uint32_t full = full0 + 8 * slot;
          mbar_expect_tx(full, kStage);
          if (rank == 0) {
            const uint32_t dst = smem_u32(ring + slot * kStageF);
            if (C > 1)
              bulk_load_multicast(dst, wd + (size_t)i * kStageF, kStage, full,
                                  mask);
            else
              bulk_load(dst, wd + (size_t)i * kStageF, kStage, full);
          }
          if (++slot == stages) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    }
    __syncwarp();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    const int wg = warp >> 2;
    const int warp4 = warp & 3;
    const int gq = lane >> 2, q = lane & 3;
    // release a stage: each warp's lane 0 on every block's empty barrier
    auto release = [&](int sl) {
      if (lane == 0)
        for (uint32_t p = 0; p < C; ++p)
          mbar_arrive_cluster(empty0 + 8 * sl, p);
    };
    // h_s of chunk cc (this thread's 16 (row, unit) pairs) into the
    // plane: element (r, u) at slab u / 32, sw_off(r, u % 32)
    auto store_h = [&](int cc, const float (&h)[16]) {
      const int ub = (wg * NCH + cc) * 32;
#pragma unroll
      for (int ug = 0; ug < 4; ++ug)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int r = warp4 * 16 + gq + 8 * rh;
          const int u = ub + ug * 8 + 2 * q;
          *reinterpret_cast<float2*>(hs + (u / kSwK) * kSlab +
                                     sw_off(r, u % kSwK)) =
              make_float2(h[4 * ug + 2 * rh], h[4 * ug + 2 * rh + 1]);
        }
    };
    // accumulator i holds row warp4*16 + gq + 8 * ((i >> 1) & 1), packed
    // column 8 * (i >> 2) + 2q + (i & 1): gate (i >> 2) & 3 of unit ub + 8
    // * (i >> 4) + 2q + (i & 1). Each chunk's start from xproj[s], group
    // ug (accumulators 16 ug to 16 ug + 15) at a time; rows >= B read 0.
    float acc[64];
    auto load_x = [&](int s, int cc, int ug) {
      const float* xs = xproj + ((size_t)s * 2 + d) * B * G4;
      const int ub = (wg * NCH + cc) * 32;
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int row = b0 + warp4 * 16 + gq + 8 * rh;
        const float* xr = xs + (size_t)row * G4 + ub + 8 * ug + 2 * q;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float2 v = row < B ? __ldg(reinterpret_cast<const float2*>(
                                         xr + g * H))
                                   : make_float2(0.f, 0.f);
          acc[16 * ug + 4 * g + 2 * rh] = v.x;
          acc[16 * ug + 4 * g + 2 * rh + 1] = v.y;
        }
      }
    };
    float c[NCH][16];
    float hn[NCH][16];                      // h_s, held until the plane
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc)
#pragma unroll
      for (int i = 0; i < 16; ++i) c[cc][i] = 0.f;
    int slot = 0;
    uint32_t phase = 0;
#pragma unroll
    for (int ug = 0; ug < 4; ++ug) load_x(0, 0, ug);

    for (int s = 0; s < T_; ++s) {
      const bool more = s + 1 < T_;
#pragma unroll
      for (int cc = 0; cc < NCH; ++cc) {
        const int ub = (wg * NCH + cc) * 32;
        int prev = -1;
        // one stage: the lo fragments of its two k8 steps from the plane,
        // then lo*hi, hi*lo, hi*hi for each; `la` stays untouched until
        // the stage's wgmmas are done (two stages later)
        auto stage = [&](int kb, uint32_t (&la)[2][4]) {
          mbar_wait(full0 + 8 * slot, phase);
          const float* st = ring + slot * kStageF + 2 * wg * kTile;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int k = kb * kKs + j * 8;
            const float* hp = hs + (k / kSwK) * kSlab;
            const int r0 = warp4 * 16 + gq, kq = k % kSwK + q;
            la[j][0] = lo_of(hp[sw_off(r0, kq)]);
            la[j][1] = lo_of(hp[sw_off(r0 + 8, kq)]);
            la[j][2] = lo_of(hp[sw_off(r0, kq + 4)]);
            la[j][3] = lo_of(hp[sw_off(r0 + 8, kq + 4)]);
          }
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            // k8 step j: 32 bytes into the stage's 64-byte rows and into
            // the plane's 128-byte rows (the swizzle applies to the
            // address the descriptor forms)
            const int k = kb * kKs + j * 8;
            const uint64_t ah = gmma_desc(hs + (k / kSwK) * kSlab + k % kSwK);
            const uint64_t bh = gmma_desc64(st + j * 8);
            wgmma_tf32_m64n128_ra(acc, la[j], bh);
            wgmma_tf32_m64n128(acc, ah, gmma_desc64(st + kTile + j * 8));
            wgmma_tf32_m64n128(acc, ah, bh);
          }
          wgmma_commit();
          if (prev >= 0) {
            wgmma_wait<1>();                // the previous stage's are done
            release(prev);
          }
          prev = slot;
          if (++slot == stages) {
            slot = 0;
            phase ^= 1;
          }
        };
        uint32_t la0[2][4], la1[2][4];
        for (int kb = 0; kb < NKS; kb += 2) {
          stage(kb, la0);
          stage(kb + 1, la1);
        }
        wgmma_wait<0>();
        release(prev);
        if (cc == NCH - 1 && more) {
          // every wgmma of this step has read h_{s-1}: the held chunks go
          // to the plane now, the last one after its cell update
          consumers_sync();
#pragma unroll
          for (int pc = 0; pc < NCH - 1; ++pc) store_h(pc, hn[pc]);
        }

        // the cell update, a group of 16 accumulators at a time; each
        // group's accumulators then take the next chunk's xproj
#pragma unroll
        for (int ug = 0; ug < 4; ++ug) {
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i0 = 16 * ug + 2 * rh + e;
              const float ig = sigmoid_fast(acc[i0]);
              const float fg = sigmoid_fast(acc[i0 + 4]);
              const float gg = tanh_fast(acc[i0 + 8]);
              const float og = sigmoid_fast(acc[i0 + 12]);
              float& cs = c[cc][4 * ug + 2 * rh + e];
              cs = fg * cs + ig * gg;
              hn[cc][4 * ug + 2 * rh + e] = og * tanh_fast(cs);
            }
            const int row = b0 + warp4 * 16 + gq + 8 * rh;
            if (row < B) {
              float* yr = ys_row(ys_f, ys_b, mode, s, d, T_, B, H, row);
              if (yr != nullptr)
                *reinterpret_cast<float2*>(yr + ub + ug * 8 + 2 * q) =
                    make_float2(hn[cc][4 * ug + 2 * rh],
                                hn[cc][4 * ug + 2 * rh + 1]);
            }
          }
          if (cc + 1 < NCH)
            load_x(s, cc + 1, ug);
          else if (more)
            load_x(s + 1, 0, ug);
        }
      }
      if (more) {
        store_h(NCH - 1, hn[NCH - 1]);
        fence_proxy_async();
        consumers_sync();    // h_s is in the plane
      }
    }
  }
  cluster_sync_all();    // no block leaves while a peer may still signal it
}

// the most stages of the ring at H: as many 32 KB stages as fit beside
// the h plane, at most kMaxStages
inline int ring_stages(int H) {
  const int n = (int)((kMaxSmem - fixed_smem(H)) / kStage);
  return n < kMaxStages ? n : kMaxStages;
}

inline const void* kernel_of(int H) {
  if (H == 128) return (const void*)fwd_f32_kernel<2>;
  if (H == 256) return (const void*)fwd_f32_kernel<4>;
  return nullptr;
}

// the launch configuration of (H, cluster, stages) over B rows; allows
// the shared memory; refuses what the kernel does not take
inline cudaError_t config(int H, int B, int cluster, int stages,
                          cudaStream_t stream, cudaLaunchConfig_t* cfg,
                          cudaLaunchAttribute* attr, const void** kernel) {
  *kernel = kernel_of(H);
  if (*kernel == nullptr || B < 1 ||
      !(cluster == 1 || cluster == 2 || cluster == 4) || stages < 2 ||
      stages > ring_stages(H))
    return cudaErrorInvalidValue;
  const size_t smem = fixed_smem(H) + (size_t)stages * kStage;
  const cudaError_t err = set_smem(*kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (B + kRows - 1) / kRows;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((tiles + cluster - 1) / cluster * cluster, 2);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace k1_rec

// ---------------------------------------------------------------------------
// launch helpers

// The cluster kernels' launches: kind 0 = K2, 1 = K3, 2 = K4's
// recurrence; dtype 0 = float32, 1 = bfloat16; a plan is a cluster size
// and a row tile (`rows` = BB).

// shared-memory bytes of a cluster kernel (the same formula as
// ops/recurrence.py::recurrence_smem)
inline size_t cl_smem(int kind, int H, int rows, int dtype) {
  if (dtype == 0) {
    if (kind == 2)
      return ((size_t)(H + rows) * kClLdaF + (size_t)rows * H) *
             sizeof(float);
    return ((size_t)H * kClLdwF + (size_t)rows * (H + 4)) * sizeof(float);
  }
  const size_t w = (size_t)H * kClLdw * sizeof(bf16);
  if (kind == 2)
    return w + (size_t)rows * kClLdw * sizeof(bf16) +
           (size_t)(H / kClU) * rows * kClU * sizeof(float);
  return w + ((size_t)2 * rows * (H + 8) + (size_t)rows * kClLdw) *
                 sizeof(bf16);
}

// the kernel of a plan, or null where ops/recurrence.py::recurrence_plan
// cannot give the plan, within a block's shared memory: bfloat16,
// clusters of 2 or 4 blocks of kClU units and row tiles of 16, 32 or 48;
// float32, clusters of 4 or 8 blocks of kClUF units and row tiles of 16
// to 80 (forward) or 16 to 48 (backward)
inline const void* cl_kernel(int kind, int H, int cluster, int rows,
                             int dtype) {
  if (rows % 16 != 0 || kind < 0 || kind > 2 ||
      cl_smem(kind, H, rows, dtype) > kMaxSmem)
    return nullptr;
  if (dtype == 0) {
    if (!(cluster == 4 || cluster == 8) || H != cluster * kClUF)
      return nullptr;
    const bool c4 = cluster == 4;
#define DSP_FWD(MT)                                                   \
  if (rows == 16 * MT && kind < 2)                                    \
    return kind ? (const void*)fwd_cluster_f32_kernel<MT, true>       \
                : (const void*)fwd_cluster_f32_kernel<MT, false>;
#define DSP_BWD(MT)                                                   \
  if (rows == 16 * MT && kind == 2)                                   \
    return c4 ? (const void*)bwd_cluster_f32_kernel<MT, 4>            \
              : (const void*)bwd_cluster_f32_kernel<MT, 8>;
    DSP_FWD(1) DSP_FWD(2) DSP_FWD(3) DSP_FWD(4) DSP_FWD(5)
    DSP_BWD(1) DSP_BWD(2) DSP_BWD(3)
#undef DSP_FWD
#undef DSP_BWD
    return nullptr;
  }
  if (dtype != 1 || !(cluster == 2 || cluster == 4) || H != cluster * kClU)
    return nullptr;
  const bool h2 = cluster == 2;
#define DSP_CL(MT)                                                         \
  if (rows == 16 * MT) {                                                   \
    if (kind == 0) return (const void*)fwd_cluster_kernel<MT, false>;     \
    if (kind == 1) return (const void*)fwd_cluster_kernel<MT, true>;      \
    if (kind == 2)                                                         \
      return h2 ? (const void*)bwd_cluster_kernel<MT, 2>                   \
                : (const void*)bwd_cluster_kernel<MT, 4>;                  \
  }
  DSP_CL(1)
  DSP_CL(2)
  DSP_CL(3)
#undef DSP_CL
  return nullptr;
}

// the launch configuration of a plan over `tiles` row tiles: grid
// (cluster * tiles, 2), cluster (cluster, 1, 1), kClWarps warps; allows
// the shared memory
inline cudaError_t cl_config(const void* kernel, size_t smem, int cluster,
                             int tiles, cudaStream_t stream,
                             cudaLaunchConfig_t* cfg,
                             cudaLaunchAttribute* attr) {
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster * tiles, 2);
  cfg->blockDim = dim3(kClWarps * 32);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// launches the plan's kernel over `tiles` row tiles with `args` (the
// kernel's parameters)
inline cudaError_t cl_launch(int kind, int H, int cluster, int rows,
                             int tiles, int dtype, void** args,
                             cudaStream_t stream) {
  const void* kernel = cl_kernel(kind, H, cluster, rows, dtype);
  if (kernel == nullptr || tiles < 1) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cl_config(kernel, cl_smem(kind, H, rows, dtype), cluster,
                              tiles, stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the fewest unit groups (of 8) per warp that keep a block at <= 8 warps
inline int groups_per_warp(int H) {
  const int ngroups = (H + 7) / 8;
  int gpw = 1;
  while (gpw * kMmaWarps < ngroups) gpw *= 2;
  return gpw;
}

template <int GPW, int MT, bool SAVE>
cudaError_t launch_fwd_bf16(const bf16* xproj, const bf16* wt, bf16* ys,
                            float* cs, bf16* gates, int T_, int B, int H,
                            int Kp, cudaStream_t stream) {
  const int Ks = smem_stride(Kp);
  const size_t smem = (size_t)2 * 16 * MT * Ks * sizeof(bf16);
  auto kernel = fwd_bf16_kernel<GPW, MT, SAVE>;
  const cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  const int nwarps = ((H + 7) / 8 + GPW - 1) / GPW;
  const dim3 grid((B + 16 * MT - 1) / (16 * MT), 2);
  kernel<<<grid, nwarps * 32, smem, stream>>>(xproj, wt, ys, cs, gates, T_, B,
                                              H, Kp, Ks);
  return cudaGetLastError();
}

template <bool SAVE>
cudaError_t fwd_bf16(const bf16* xproj, const bf16* w_hh, bf16* ys,
                     float* cs, bf16* gates, int T_, int B, int H, bf16* wt,
                     cudaStream_t stream) {
  const int Kp = round_up(H, 32);
  cudaError_t err = pack<bf16>(w_hh, wt, 4 * H, H, Kp, 1, stream);
  if (err != cudaSuccess) return err;
  switch (groups_per_warp(H)) {
    case 1: return launch_fwd_bf16<1, 2, SAVE>(xproj, wt, ys, cs, gates, T_,
                                               B, H, Kp, stream);
    case 2: return launch_fwd_bf16<2, 2, SAVE>(xproj, wt, ys, cs, gates, T_,
                                               B, H, Kp, stream);
    case 4: return launch_fwd_bf16<4, 2, SAVE>(xproj, wt, ys, cs, gates, T_,
                                               B, H, Kp, stream);
    default: return launch_fwd_bf16<8, 2, SAVE>(xproj, wt, ys, cs, gates, T_,
                                                B, H, Kp, stream);
  }
}

// float32 block shape: (round_up(H, 32), by) threads, RB * by rows
inline dim3 f32_block(int H) {
  const int bx = round_up(H, 32);
  return dim3(bx, bx >= kTargetThreads ? 1 : kTargetThreads / bx);
}

template <bool SAVE>
cudaError_t fwd_f32(const float* xproj, const float* w_hh, float* ys,
                    float* ys_b, float* cs, float* gates, int T_, int B,
                    int H, int mode, cudaStream_t stream) {
  const dim3 block = f32_block(H);
  const int BB = kRowsPerThread * block.y;
  const size_t smem = (size_t)H * BB * sizeof(float);
  auto kernel = fwd_f32_kernel<kRowsPerThread, SAVE>;
  const cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((B + BB - 1) / BB, 2), block, smem, stream>>>(
      xproj, w_hh, ys, ys_b, cs, gates, T_, B, H, mode);
  return cudaGetLastError();
}

template <int GPW, int MT>
cudaError_t launch_bwd_bf16(const bf16* dys, const float* cs,
                            const bf16* gates, const bf16* wb, bf16* dx,
                            int T_, int B, int H, int Kp,
                            cudaStream_t stream) {
  const int Ks = smem_stride(Kp);
  const size_t smem = (size_t)2 * 16 * MT * Ks * sizeof(bf16);
  auto kernel = bwd_bf16_kernel<GPW, MT>;
  const cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  const int nwarps = ((H + 7) / 8 + GPW - 1) / GPW;
  const dim3 grid((B + 16 * MT - 1) / (16 * MT), 2);
  kernel<<<grid, nwarps * 32, smem, stream>>>(dys, cs, gates, wb, dx, T_, B,
                                              H, Kp, Ks);
  return cudaGetLastError();
}

// two m16 tiles per block where two rows of 4H bf16 fit shared memory
// twice (H <= 256 with room to spare), one above
template <int GPW>
cudaError_t bwd_bf16_rows(const bf16* dys, const float* cs,
                          const bf16* gates, const bf16* wb, bf16* dx,
                          int T_, int B, int H, int Kp, cudaStream_t stream) {
  if ((size_t)2 * 32 * smem_stride(Kp) * sizeof(bf16) <= kMaxSmem)
    return launch_bwd_bf16<GPW, 2>(dys, cs, gates, wb, dx, T_, B, H, Kp,
                                   stream);
  return launch_bwd_bf16<GPW, 1>(dys, cs, gates, wb, dx, T_, B, H, Kp,
                                 stream);
}

cudaError_t bwd_bf16(const bf16* dys, const float* cs, const bf16* gates,
                     const bf16* w_hh, bf16* dx, int T_, int B, int H,
                     bf16* wb, cudaStream_t stream) {
  const int Kp = round_up(4 * H, 32);
  cudaError_t err = pack<bf16>(w_hh, wb, H, 4 * H, Kp, 0, stream);
  if (err != cudaSuccess) return err;
  switch (groups_per_warp(H)) {
    case 1: return bwd_bf16_rows<1>(dys, cs, gates, wb, dx, T_, B, H, Kp,
                                    stream);
    case 2: return bwd_bf16_rows<2>(dys, cs, gates, wb, dx, T_, B, H, Kp,
                                    stream);
    case 4: return bwd_bf16_rows<4>(dys, cs, gates, wb, dx, T_, B, H, Kp,
                                    stream);
    default: return bwd_bf16_rows<8>(dys, cs, gates, wb, dx, T_, B, H, Kp,
                                     stream);
  }
}

cudaError_t bwd_f32(const float* dys, const float* cs, const float* gates,
                    const float* w_hh, float* dx, int T_, int B, int H,
                    float* wT, cudaStream_t stream) {
  cudaError_t err = pack<float>(w_hh, wT, 4 * H, H, H, 1, stream);
  if (err != cudaSuccess) return err;
  const dim3 block = f32_block(H);
  const int BB = kRowsPerThread * block.y;
  const size_t smem = (size_t)4 * H * BB * sizeof(float);
  auto kernel = bwd_f32_kernel<kRowsPerThread>;
  err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((B + BB - 1) / BB, 2), block, smem, stream>>>(
      dys, cs, gates, wT, dx, T_, B, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the workspace dsp_lstm_recurrence_fwd needs without a cluster
// plan: the bfloat16 streaming kernel packs W_hh transposed to
// (2, 4H, round_up(H, 32)); float32 reads it as is.
size_t dsp_lstm_fwd_workspace_bytes(int H, int dtype) {
  if (dtype != 1) return 0;
  return (size_t)2 * 4 * H * round_up(H, 32) * sizeof(bf16);
}

// How many clusters of a plan's kernel (kind 0 = K2, 1 = K3, 2 = K4's
// recurrence; storage dtype 0 = float32, 1 = bfloat16; cluster size, row
// tile `rows`) the card holds at once (cudaOccupancyMaxActiveClusters at
// the kernel's shared memory), into *clusters; refuses a plan the
// launchers refuse.
cudaError_t dsp_lstm_recurrence_clusters(int kind, int H, int cluster,
                                         int rows, int dtype,
                                         int* clusters) {
  const void* kernel = cl_kernel(kind, H, cluster, rows, dtype);
  if (kernel == nullptr || clusters == nullptr) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t err = cl_config(kernel, cl_smem(kind, H, rows, dtype),
                                    cluster, 1, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// K2 (save = 0) and K3 (save = 1). xproj (T, 2, B, 4H), w_hh (2, H, 4H),
// ys (T, 2, B, H) in the storage type (dtype 0 = float32, 1 = bfloat16);
// with save, cs (T, 2, B, H) float32 and gates (T, 2, B, 4H) in the
// storage type (else both may be null). `cluster` > 0 runs the cluster
// kernel of the dtype and the plan (cluster, rows) (every pointer 16-byte
// aligned; no workspace); 0 the streaming kernel (bfloat16: workspace of
// dsp_lstm_fwd_workspace_bytes) or the float32 streaming kernel. Runs
// on `stream`, allocates nothing, returns the launch's error code.
//
// What bounds it, at B=512, H=256, T=13 (a comb layer of the training
// path): 2*2*T*B*H*4H = 7.0 GFLOP (7 us at the bf16 tensor-core peak)
// against 35 MB of compulsory bytes for K2 (xproj, w_hh, ys: 10 us at
// 3.35 TB/s) and 76 MB for K3 (+ cs, gates: 23 us): bytes bind. The
// streaming kernel has only 2 * B/32 = 32 blocks at B=512, each walking a
// serial chain of L2 weight loads and mma.sync per step (GPW x Kp/32
// k-steps a warp), 100 of 132 SMs idle. The cluster kernel reads the
// weights once per block, spreads the batch over 4x the blocks (88 at
// H=256, 128 at H=128 on an H100), and cuts a warp's chain to MT x 4 x
// H/16 mma.sync from shared memory; what it adds is one cluster barrier
// and the DSMEM copies of h per step.
//
// float32: the same products are 3 x 7.0 GFLOP in 3xTF32 (42 us at
// 495 TFLOP/s) against 70 MB (K2) or 138 MB (K3) of compulsory bytes (21
// and 41 us). The float32 streaming kernel (one thread per unit, 16 rows a
// thread, 2 x B/16 = 64 blocks at H=256) runs FFMA on the CUDA cores and
// reads its direction's whole W_hh (1 MB) from L2 at every step. The
// float32 cluster kernel keeps 32 units' W slice resident in each of 8
// blocks (H=256), runs 3xTF32 mma.sync from shared memory, and spreads
// the batch over clusters as the bfloat16 one does.
cudaError_t dsp_lstm_recurrence_fwd(const void* xproj, const void* w_hh,
                                    void* ys, void* cs, void* gates, int T_,
                                    int B, int H, int save, int dtype,
                                    int cluster, int rows, void* workspace,
                                    void* stream) {
  if (T_ < 1 || B < 1 || H < 1 || H > kMaxHidden ||
      (save && (cs == nullptr || gates == nullptr)))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster != 0) {
    if (!aligned16(xproj) || !aligned16(w_hh) || !aligned16(ys) ||
        (save && (!aligned16(cs) || !aligned16(gates))))
      return cudaErrorInvalidValue;
    const int tiles = (B + rows - 1) / rows;
    if (dtype == 0) {
      void* ys_b = nullptr;
      int mode = kYsSteps;
      void* args[] = {&xproj, &w_hh, &ys, &ys_b, &cs,
                      &gates, &T_,   &B,  &H,    &mode};
      return cl_launch(save ? 1 : 0, H, cluster, rows, tiles, dtype, args,
                       st);
    }
    void* args[] = {&xproj, &w_hh, &ys, &cs, &gates, &T_, &B, &H};
    return cl_launch(save ? 1 : 0, H, cluster, rows, tiles, dtype, args, st);
  }
  if (dtype == 0) {
    auto x = static_cast<const float*>(xproj);
    auto w = static_cast<const float*>(w_hh);
    auto y = static_cast<float*>(ys);
    return save ? fwd_f32<true>(x, w, y, nullptr, static_cast<float*>(cs),
                                static_cast<float*>(gates), T_, B, H,
                                kYsSteps, st)
                : fwd_f32<false>(x, w, y, nullptr, nullptr, nullptr, T_, B,
                                 H, kYsSteps, st);
  }
  if (dtype == 1) {
    if (workspace == nullptr) return cudaErrorInvalidValue;
    auto x = static_cast<const bf16*>(xproj);
    auto w = static_cast<const bf16*>(w_hh);
    auto y = static_cast<bf16*>(ys);
    auto wt = static_cast<bf16*>(workspace);
    return save ? fwd_bf16<true>(x, w, y, static_cast<float*>(cs),
                                 static_cast<bf16*>(gates), T_, B, H, wt, st)
                : fwd_bf16<false>(x, w, y, nullptr, nullptr, T_, B, H, wt,
                                  st);
  }
  return cudaErrorInvalidValue;
}

// K1's recurrence at float32 (ops/recurrence.py::lstm_recurrence_k1, the
// float32 route of the fused layer): K2's arithmetic over xproj
// (T, 2, B, 4H) float32 (the projection kernel's output, fused_bilstm.cu),
// with h stored as K1 stores it: ys_f and ys_b (T, B, H) in true time, or
// with seq_out = 0 the (1, B, H) final states. `cluster` > 0 runs the
// float32 cluster kernel of the plan (cluster, rows) (every pointer
// 16-byte aligned); 0 the float32 streaming kernel. Runs on `stream`,
// allocates nothing, returns the launch's error code.
cudaError_t dsp_lstm_recurrence_fwd_k1(const void* xproj, const void* w_hh,
                                       void* ys_f, void* ys_b, int T_, int B,
                                       int H, int seq_out, int cluster,
                                       int rows, void* stream) {
  if (T_ < 1 || B < 1 || H < 1 || H > kMaxHidden || ys_f == nullptr ||
      ys_b == nullptr)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int mode = seq_out ? kYsTrueTime : kYsFinal;
  if (cluster != 0) {
    if (!aligned16(xproj) || !aligned16(w_hh) || !aligned16(ys_f) ||
        !aligned16(ys_b) || rows < 1)
      return cudaErrorInvalidValue;
    void* cs = nullptr;
    void* gates = nullptr;
    void* args[] = {&xproj, &w_hh, &ys_f, &ys_b, &cs,
                    &gates, &T_,   &B,    &H,    &mode};
    return cl_launch(0, H, cluster, rows, (B + rows - 1) / rows, 0, args,
                     st);
  }
  return fwd_f32<false>(static_cast<const float*>(xproj),
                        static_cast<const float*>(w_hh),
                        static_cast<float*>(ys_f), static_cast<float*>(ys_b),
                        nullptr, nullptr, T_, B, H, mode, st);
}

// How many clusters of K1's float32 wgmma recurrence (k1_rec) at hidden
// size H (128 or 256), `cluster` blocks and a ring of `stages` the card
// holds at once (cudaOccupancyMaxActiveClusters), into *clusters;
// refuses what dsp_k1_rec_f32 refuses.
cudaError_t dsp_k1_rec_f32_clusters(int H, int cluster, int stages,
                                    int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const void* kernel;
  if (clusters == nullptr) return cudaErrorInvalidValue;
  const cudaError_t err =
      k1_rec::config(H, cluster * k1_rec::kRows, cluster, stages, nullptr,
                     &cfg, &attr, &kernel);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// K1's recurrence at float32 on wgmma (ops/recurrence.py::
// lstm_recurrence_k1 where k1_rec_plan takes this kernel): xproj (T, 2, B,
// 4H) float32 as dsp_lstm_recurrence_fwd_k1 reads it, `wp` W_hh packed by
// ops/fused_lstm.py::pack_rec_weights, ys_f and ys_b as that function
// writes them; H 128 or 256, clusters of 1, 2 or 4 blocks, a ring of 2
// to k1_rec::ring_stages(H) stages (5 at 256, 6 at 128); every pointer
// 16-byte aligned. Runs
// on `stream`, allocates nothing, returns the launch's error code.
cudaError_t dsp_k1_rec_f32(const void* xproj, const void* wp, void* ys_f,
                           void* ys_b, int T_, int B, int H, int seq_out,
                           int cluster, int stages, void* stream) {
  if (T_ < 1 || ys_f == nullptr || ys_b == nullptr || !aligned16(xproj) ||
      !aligned16(wp) || !aligned16(ys_f) || !aligned16(ys_b))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const void* kernel;
  cudaError_t err = k1_rec::config(H, B, cluster, stages,
                                   static_cast<cudaStream_t>(stream), &cfg,
                                   &attr, &kernel);
  if (err != cudaSuccess) return err;
  int mode = seq_out ? kYsTrueTime : kYsFinal;
  void* args[] = {&xproj, &wp, &ys_f, &ys_b, &T_, &B, &stages, &mode};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Bytes of the workspace dsp_lstm_recurrence_bwd needs without a cluster
// plan: the bfloat16 streaming kernel packs W_hh to (2, H, round_up(4H,
// 32)); float32 transposes it to (2, 4H, H).
size_t dsp_lstm_bwd_workspace_bytes(int H, int dtype) {
  if (dtype == 1) return (size_t)2 * H * round_up(4 * H, 32) * sizeof(bf16);
  return (size_t)2 * 4 * H * H * sizeof(float);
}

// K4, the reverse-time recurrence: dys (T, 2, B, H) and gates
// (T, 2, B, 4H) in the storage type, cs (T, 2, B, H) float32, w_hh
// (2, H, 4H) -> dx = dxproj (T, 2, B, 4H) in the storage type. dh and dc
// carries start at zero at step T-1; c_{-1} = 0. `cluster` > 0 runs the
// cluster kernel of the dtype and the plan (cluster, rows) (every pointer
// 16-byte aligned; no workspace); 0 the bfloat16 or float32 streaming
// kernel (workspace of dsp_lstm_bwd_workspace_bytes).
//
// What bounds it, at B=512, H=256, T=13: 2*2*(T-1)*B*4H*H = 6.4 GFLOP
// (6.5 us at the bf16 peak) against 76 MB of compulsory bytes (dys,
// gates, cs, w_hh, dx: 23 us): bytes bind. The streaming kernel: as the
// forward's, 32 blocks at B=512 that read their direction's packed W_hh
// from L2 at every step, and scattered 2- and 4-byte loads of the
// residuals in the fragment layout. The cluster kernel: weights resident,
// 16-byte residual loads issued a step ahead, a warp's chain MT x C x
// 4*64/16 mma.sync from shared memory; it adds the f32 partial sums (C x BB x 64
// x 4 bytes a block) through DSMEM and two cluster barriers per step.
// float32: 3 x 6.4 GFLOP in 3xTF32 (39 us) against 138 MB (41 us): bytes
// bind; the float32 cluster kernel is the bfloat16 one with f32 da, 32
// units a block (clusters of 8 at H=256) and 3xTF32 products.
cudaError_t dsp_lstm_recurrence_bwd(const void* dys, const void* cs,
                                    const void* gates, const void* w_hh,
                                    void* dx, int T_, int B, int H, int dtype,
                                    int cluster, int rows, void* workspace,
                                    void* stream) {
  if (T_ < 1 || B < 1 || H < 1 || H > kMaxHidden)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster != 0) {
    if (!aligned16(dys) || !aligned16(cs) || !aligned16(gates) ||
        !aligned16(w_hh) || !aligned16(dx))
      return cudaErrorInvalidValue;
    void* args[] = {&dys, &cs, &gates, &w_hh, &dx, &T_, &B};
    return cl_launch(2, H, cluster, rows, (B + rows - 1) / rows, dtype, args,
                     st);
  }
  if (workspace == nullptr) return cudaErrorInvalidValue;
  if (dtype == 0)
    return bwd_f32(static_cast<const float*>(dys),
                   static_cast<const float*>(cs),
                   static_cast<const float*>(gates),
                   static_cast<const float*>(w_hh), static_cast<float*>(dx),
                   T_, B, H, static_cast<float*>(workspace), st);
  if (dtype == 1)
    return bwd_bf16(static_cast<const bf16*>(dys),
                    static_cast<const float*>(cs),
                    static_cast<const bf16*>(gates),
                    static_cast<const bf16*>(w_hh), static_cast<bf16*>(dx),
                    T_, B, H, static_cast<bf16*>(workspace), st);
  return cudaErrorInvalidValue;
}

// Bytes of the workspace dsp_lstm_dw_hh needs for a plan of `splits`:
// the f32 partials (splits, 2, H, 4H) when splits > 1, else none.
size_t dsp_lstm_dw_hh_workspace_bytes(int H, int splits) {
  if (splits <= 1) return 0;
  return (size_t)splits * 2 * H * 4 * H * sizeof(float);
}

// K4, the weight gradient: dw (2, H, 4H) float32 = sum over s >= 1 and b
// of ys[s-1, d, b, :]^T dx[s, d, b, :]; ys (T, 2, B, H) and dx
// (T, 2, B, 4H) in the storage type. Every element of dw is written (all
// zeros when T = 1). The plan (splits, rows) cuts the K = (T-1)*B rows
// into `splits` ranges of `rows` rows, every one non-empty (one split of 0
// rows when K = 0); with splits > 1, workspace
// holds dsp_lstm_dw_hh_workspace_bytes(H, splits) bytes, 16-byte aligned.
// Two launches: the split products, then the fixed-order sum of the
// partials (none for one split).
//
// What bounds it, at B=512, H=256, T=13: 2*2*(T-1)*B*H*4H = 6.4 GFLOP
// (6.5 us) against 36 MB of compulsory bytes (ys, dx, dw: 11 us): bytes
// bind. 128 x 128 output tiles give 32 tiles at H=256 (8 at H=128), too
// few for 132 SMs; splitting K eight ways (sixteen at H=128) gives one
// wave of 256 (128) blocks of 8 warps, two resident per SM, each keeping
// two 64-row slabs in flight. Each operand is read H/128 or 4H/128 times
// from L2 (100 MB at H=256, where the earlier 64 x 128 tiles read 150
// MB); the partials add 2 * splits * 2 MB (H=256), most of it in L2.
// float32: 3 x 6.4 GFLOP in 3xTF32 (39 us at 495 TFLOP/s) against 72 MB
// (21 us): the products bind. They run on wgmma over slabs transposed to
// K-major as they are staged; one block an SM, so the plan's 256 blocks
// take two waves at H=256. Fewer, longer splits would take one, but sum
// more rows in one f32 chain: 4 splits put H=256 past the 1e-5 gate of
// chip_smoke.py on the H100, 8 stay within it.
cudaError_t dsp_lstm_dw_hh(const void* ys, const void* dx, void* dw, int T_,
                           int B, int H, int splits, int rows, int dtype,
                           void* workspace, void* stream) {
  if (T_ < 1 || B < 1 || H < 1 || dw == nullptr || splits < 1 || rows < 0 ||
      2 * (long long)splits > 65535)
    return cudaErrorInvalidValue;
  const long long K = (long long)(T_ - 1) * B;
  const bool covers = K == 0 ? splits == 1
                             : (long long)splits * rows >= K &&
                                   (long long)(splits - 1) * rows < K;
  if (!covers || K > 0x7fffffff || (splits > 1 && workspace == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(splits > 1 ? workspace : dw);
  const dim3 grid((4 * H + kDwN - 1) / kDwN, (H + kDwM - 1) / kDwM,
                  2 * splits);
  // 16-byte copies need rows of whole 16-byte chunks and aligned bases
  const bool aligned = reinterpret_cast<uintptr_t>(ys) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  cudaError_t err;
  if (dtype == 0) {
    // two buffers of four planes, and room to align them to 1,024 bytes
    const size_t smem = (size_t)2 * 4 * kDwTile * sizeof(float) + 1024;
    err = set_smem((const void*)dw_f32_kernel, smem);
    if (err != cudaSuccess) return err;
    dw_f32_kernel<<<grid, kDwThreads, smem, st>>>(
        static_cast<const float*>(ys), static_cast<const float*>(dx), out, B,
        H, (int)K, rows, aligned && H % 4 == 0);
  } else if (dtype == 1) {
    const size_t smem = (size_t)kDwStages * kDwKBf16 *
                        (kDwLdaBf16 + kDwLdbBf16) * sizeof(bf16);
    err = set_smem((const void*)dw_bf16_kernel, smem);
    if (err != cudaSuccess) return err;
    dw_bf16_kernel<<<grid, kDwThreads, smem, st>>>(
        static_cast<const bf16*>(ys), static_cast<const bf16*>(dx), out, B,
        H, (int)K, rows, aligned && H % 8 == 0);
  } else {
    return cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n4 = (size_t)2 * H * H;       // float4s of (2, H, 4H)
  const int blocks = (int)(n4 / 256 + 1 < 1024 ? n4 / 256 + 1 : 1024);
  dw_reduce_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const float4*>(workspace), static_cast<float4*>(dw), n4,
      splits);
  return cudaGetLastError();
}

const char* dsp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
