// K2 and K3: stage 1 and the banded eval of the v3 align pipe.
//
// Replace the XLA device programs of the JAX package's `_row_core_v3` (its
// ops/align_tpu.py): stage 1, the occupancy product with its packed maxes
// (:1108-1157), and stages 3-4, the band counts and their election
// (:1175-1212). Both are bit-exact with the plain torch versions beside
// their wrappers in ops/align_gpu.py (`stage1_pack_plain`,
// `band_counts_plain`).
//
// K2 (k2_stage1). For every task (dispatch row x query) it forms
// M = qocc . rocc^T, (2*NQB) query half-blocks x NRB reference blocks over
// H hashed canonical 8-mers, {0,1} int8, and keeps per query block q and
// over reference blocks rr the maxima of ((Ma + Mb) << 13) | rr,
// (Ma << 13) | rr and (Mb << 13) | rr, Ma and Mb being rows 2q and 2q+1.
// Counts stay <= 64 (a half block holds at most 64 distinct buckets), so
// << 13 cannot overflow, and the packed max gives ties to the larger rr.
// Design: a CTA computes a 64 x 128 tile of M (32 query blocks x 128
// reference blocks) with mma.sync m16n8k32 u8 x u8 -> s32 from a two-stage
// cp.async ring in shared memory (rows padded to 80 bytes, so fragment
// loads are free of bank conflicts); four warps of 32 x 64 each. The
// epilogue pairs adjacent half rows by a shuffle (rows g and g+1 of a
// fragment are 4 lanes apart), reduces the three packs over the tile's
// columns in registers and across the 4 lanes of a row, and atomicMaxes
// them into the three (tasks, NQB) outputs, which the wrapper zeroes: the
// score matrix never reaches device memory. Bound on an H100 SXM: the
// products, 2 * 2*NQB * NRB * H operations a task, against the 1,979
// TOPS int8 dense tensor rate. Left for later: wgmma from a TMA ring, and
// sharing a CTA's reference tile across the K queries of its row.
//
// K3 (k3_bands). For every fine block f (32 query bases) and each of the
// four bands (candidate 1 and 2, forward and reverse), the count of valid
// query bases (code < 4) equal to the window base at each of BAND = WIN-32
// shifts, written as int8 (stages 5-6 read them), and the election: the
// max over bands and shifts of (count << 12) | tag | shift, tags 3072
// (candidate 1, forward), 2048 (candidate 1, reverse), 1024 (candidate 2,
// forward), 0 (candidate 2, reverse), so ties go to candidate 1, then the
// forward strand, then the larger shift. Design: a CTA of 256 threads
// walks fine blocks (grid-stride); the 32 query bases and the four windows
// sit in shared memory, a thread takes a shift and counts all four bands,
// and a warp then block max gives the election. Bound on an H100 SXM:
// 2 int32 operations (compare, add) a base, shift and band against the
// 33.5 TOPS int32 rate, or the windows and counts it moves against 3.35
// TB/s, whichever is larger. Left for later: four compares a byte-SIMD
// instruction (__vcmpeq4), and fusing the window gather.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// ---- K2 ----------------------------------------------------------------
constexpr int K2_BM = 64;            // query half-block rows a CTA
constexpr int K2_BN = 128;           // reference blocks a CTA
constexpr int K2_BK = 64;            // hash buckets (bytes) a stage
constexpr int K2_LDS = K2_BK + 16;   // padded shared row, bytes
constexpr int K2_THREADS = 128;      // 2 x 2 warps of 32 x 64
constexpr int RB_BITS = 13;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(K2_THREADS)
stage1_kernel(const uint8_t* __restrict__ qocc,
              const uint8_t* __restrict__ rocc,
              const int32_t* __restrict__ r_rows,
              const int32_t* __restrict__ q_rows, int K, int M2, int NRB,
              int H, int32_t* __restrict__ p_sum, int32_t* __restrict__ p_a,
              int32_t* __restrict__ p_b) {
  __shared__ __align__(16) uint8_t As[2][K2_BM * K2_LDS];
  __shared__ __align__(16) uint8_t Bs[2][K2_BN * K2_LDS];
  const int task = blockIdx.x;
  const int m0 = blockIdx.y * K2_BM;
  const int n0 = blockIdx.z * K2_BN;
  const uint8_t* A = qocc + (size_t)q_rows[task] * M2 * H;
  const uint8_t* B = rocc + (size_t)r_rows[task / K] * NRB * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;

  auto load = [&](int stage, int k0) {
    for (int c = tid; c < K2_BM * (K2_BK / 16); c += K2_THREADS) {
      const int r = c / (K2_BK / 16), col = (c % (K2_BK / 16)) * 16;
      const bool ok = m0 + r < M2;
      cp_async16(&As[stage][r * K2_LDS + col],
                 ok ? A + (size_t)(m0 + r) * H + k0 + col : A, ok);
    }
    for (int c = tid; c < K2_BN * (K2_BK / 16); c += K2_THREADS) {
      const int r = c / (K2_BK / 16), col = (c % (K2_BK / 16)) * 16;
      const bool ok = n0 + r < NRB;
      cp_async16(&Bs[stage][r * K2_LDS + col],
                 ok ? B + (size_t)(n0 + r) * H + k0 + col : B, ok);
    }
    cp_async_commit();
  };

  int acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  const int KT = H / K2_BK;
  load(0, 0);
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) {
      load((kt + 1) & 1, (kt + 1) * K2_BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* as = As[kt & 1];
    const uint8_t* bs = Bs[kt & 1];
#pragma unroll
    for (int ks = 0; ks < K2_BK; ks += 32) {
      uint32_t af[2][4], bf[8][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint8_t* p = as + (wm + mt * 16 + g) * K2_LDS + ks + tig * 4;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * K2_LDS);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * K2_LDS + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const uint8_t* p = bs + (wn + nt * 8 + g) * K2_LDS + ks + tig * 4;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma_u8(acc[mt][nt], af[mt], bf[nt]);
    }
    __syncthreads();
  }

  // Epilogue. Accumulator i of a fragment sits at row g + 8 * (i >> 1),
  // column 2 * tig + (i & 1); half rows 2q and 2q + 1 are rows g and g + 1
  // for even g, whose partner is lane + 4.
  const int NQB = M2 >> 1;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int best_s = -1, best_a = -1, best_b = -1;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ma = acc[mt][nt][2 * h + j];
          const int mb = __shfl_down_sync(FULL, ma, 4);
          const int col = n0 + wn + nt * 8 + tig * 2 + j;
          if (col < NRB) {
            best_s = max(best_s, ((ma + mb) << RB_BITS) | col);
            best_a = max(best_a, (ma << RB_BITS) | col);
            best_b = max(best_b, (mb << RB_BITS) | col);
          }
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        best_s = max(best_s, __shfl_xor_sync(FULL, best_s, o));
        best_a = max(best_a, __shfl_xor_sync(FULL, best_a, o));
        best_b = max(best_b, __shfl_xor_sync(FULL, best_b, o));
      }
      const int row = m0 + wm + mt * 16 + h * 8 + g;
      if (tig == 0 && (g & 1) == 0 && row < M2 && best_s >= 0) {
        const size_t o = (size_t)task * NQB + (row >> 1);
        atomicMax(p_sum + o, best_s);
        atomicMax(p_a + o, best_a);
        atomicMax(p_b + o, best_b);
      }
    }
  }
}

// ---- K3 ----------------------------------------------------------------
constexpr int K3_THREADS = 256;
constexpr int NBANDS = 4;
constexpr int FINE = 32;
constexpr int MAX_WIN = 512 + FINE;  // BAND <= 512 (9 bits of shift)
constexpr int K3_CTAS_PER_SM = 8;

__device__ __forceinline__ int band_tag(int b) {
  return (b < 2 ? 2048 : 0) | ((b & 1) ? 0 : 1024);
}

__global__ void __launch_bounds__(K3_THREADS)
band_kernel(const int8_t* __restrict__ wins, const int8_t* __restrict__ q,
            int n, int win, int8_t* __restrict__ cnt,
            int32_t* __restrict__ bb) {
  __shared__ int8_t ws[NBANDS][MAX_WIN];
  __shared__ int8_t qs[FINE];
  __shared__ int red[K3_THREADS / 32];
  const int band = win - FINE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int f = blockIdx.x; f < n; f += gridDim.x) {
    for (int i = tid; i < NBANDS * win; i += K3_THREADS) {
      const int b = i / win, x = i - b * win;
      ws[b][x] = wins[((size_t)b * n + f) * win + x];
    }
    if (tid < FINE) {
      const int8_t c = q[(size_t)f * FINE + tid];
      qs[tid] = c < 4 ? c : (int8_t)-1;  // -1 matches no window base
    }
    __syncthreads();
    int best = -1;
    for (int t = tid; t < band; t += K3_THREADS) {
#pragma unroll
      for (int b = 0; b < NBANDS; ++b) {
        int c = 0;
#pragma unroll
        for (int p = 0; p < FINE; ++p) c += ws[b][t + p] == qs[p];
        cnt[((size_t)b * n + f) * band + t] = (int8_t)c;
        best = max(best, (c << 12) | band_tag(b) | t);
      }
    }
    best = __reduce_max_sync(FULL, best);
    if (lane == 0) red[warp] = best;
    __syncthreads();
    if (warp == 0) {
      int v = lane < K3_THREADS / 32 ? red[lane] : -1;
      v = __reduce_max_sync(FULL, v);
      if (lane == 0) bb[f] = v;
    }
    __syncthreads();  // shared memory is reloaded for the next block
  }
}

}  // namespace

extern "C" {

// K2. qocc: (Gq, M2, H) int8 {0,1}; rocc: (Gr, NRB, H) int8 {0,1}; r_rows:
// (tasks / K,) int32; q_rows: (tasks,) int32; p_sum, p_a, p_b: (tasks,
// M2 / 2) int32, zeroed by the caller. H % 64 == 0. Returns
// cudaGetLastError().
int k2_stage1(const uint8_t* qocc, const uint8_t* rocc, const int32_t* r_rows,
              const int32_t* q_rows, int tasks, int K, int M2, int NRB, int H,
              int32_t* p_sum, int32_t* p_a, int32_t* p_b, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tasks, (M2 + K2_BM - 1) / K2_BM, (NRB + K2_BN - 1) / K2_BN);
  stage1_kernel<<<grid, K2_THREADS, 0, s>>>(qocc, rocc, r_rows, q_rows, K, M2,
                                            NRB, H, p_sum, p_a, p_b);
  return (int)cudaGetLastError();
}

// K3. wins: (4, n, win) int8; qb: (n, 32) int8; cnt: (4, n, win - 32) int8;
// bb: (n,) int32. 32 < win <= 544. Returns cudaGetLastError().
int k3_bands(const int8_t* wins, const int8_t* qb, int n, int win,
             int8_t* cnt, int32_t* bb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = n < sms * K3_CTAS_PER_SM ? n : sms * K3_CTAS_PER_SM;
  band_kernel<<<blocks, K3_THREADS, 0, s>>>(wins, qb, n, win, cnt, bb);
  return (int)cudaGetLastError();
}

const char* vk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
