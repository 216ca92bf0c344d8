// K1: exact weighted occupancy count for the prefilter.
//
// Replaces the jitted XLA program `_group_matmul_accum_w` of the JAX
// package (its ops/prefilter.py:275-302), which scatters one chunk of
// the pattern COO into a {0,1} bf16 (patterns x genomes) occupancy and
// accumulates counts += occ^T (w * occ) in f32, one byte limb of w at a time.
//
// Here, per chunk of `ng` patterns:
//   1. `scatter_kernel` (one warp per pattern) writes occT[g, r] = 1 for every
//      genome g of pattern r into a zeroed uint8 (n_pad x k_pad) occupancy,
//      genome-major so that both GEMM operands read it along the pattern axis.
//   2. `count_kernel` accumulates counts[i, j] += sum_r occ[r,i] w[r] occ[r,j]
//      into the int32 (n x n) counts with integer tensor-core products
//      (mma.sync m16n8k32 u8 x u8 -> s32). The weight is split into byte limbs
//      (w < 2^24, so at most 3): operand B of limb l is occ * ((w >> 8l) & 255),
//      built in registers from the occupancy bytes and the packed limb bytes.
//      Each limb has its own s32 accumulator, recombined as sum_l acc_l << 8l in
//      the epilogue. Every sum is an exact integer: the result equals the JAX
//      package's rint(f32) counts bit for bit while those are exact (< 2^24),
//      and stays exact up to 2^31.
//
// Bound on an H100 SXM: 2 * rows * n^2 integer operations per chunk against
// the 1,979 TOPS dense int8 tensor rate, or the bytes of the COO chunk and a
// read and write of the int32 counts against 3.35 TB/s, whichever is larger.
//
// Left for later: the symmetric half of the tiles (counts is symmetric, so half
// the products are repeated); wgmma with TMA-fed shared-memory rings instead of
// mma.sync from one shared-memory stage; a sparse path for occupancies far below
// 1% density; limb counts other than the maximum over the whole index.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;      // output tile edge (genomes) per block
constexpr int KSTEP = 32;     // pattern rows per mma k-step
constexpr int THREADS = 128;  // 4 warps, each a 32 x 32 quadrant of the tile
constexpr int SROW = 12;      // shared row stride in 32-bit words: 8 used,
                              // padded so fragment loads hit distinct banks

__global__ void scatter_kernel(const int32_t* __restrict__ gids,
                               const int32_t* __restrict__ offs, int ng,
                               uint8_t* __restrict__ occT, int64_t ld) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= ng) return;
  const int lo = offs[r], hi = offs[r + 1];
  for (int e = lo + lane; e < hi; e += 32)
    occT[(int64_t)gids[e] * ld + r] = 1;
}

__device__ __forceinline__ void mma_u8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int L>
__global__ void __launch_bounds__(THREADS)
count_kernel(const uint8_t* __restrict__ occT, int64_t ld, int k_len,
             const int32_t* __restrict__ w, int ng,
             int32_t* __restrict__ counts, int n) {
  __shared__ __align__(16) uint32_t As[TILE * SROW];
  __shared__ __align__(16) uint32_t Bs[TILE * SROW];
  __shared__ uint32_t Wp[L][KSTEP / 4];  // limb bytes, 4 pattern rows a word

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma groupID, thread in group
  const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  int acc[L][2][4][4];
#pragma unroll
  for (int l = 0; l < L; ++l)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[l][mt][nt][c] = 0;

  // Each thread copies 16 bytes of the A tile and 16 of the B tile a step.
  const int lrow = tid >> 1, lhalf = tid & 1;
  const uint8_t* a_src = occT + (int64_t)(i0 + lrow) * ld + lhalf * 16;
  const uint8_t* b_src = occT + (int64_t)(j0 + lrow) * ld + lhalf * 16;

  for (int k0 = 0; k0 < k_len; k0 += KSTEP) {
    *reinterpret_cast<uint4*>(&As[lrow * SROW + lhalf * 4]) =
        *reinterpret_cast<const uint4*>(a_src + k0);
    *reinterpret_cast<uint4*>(&Bs[lrow * SROW + lhalf * 4]) =
        *reinterpret_cast<const uint4*>(b_src + k0);
    if (tid < L * (KSTEP / 4)) {
      const int l = tid / (KSTEP / 4), q = tid % (KSTEP / 4);
      uint32_t packed = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = k0 + q * 4 + b;
        const uint32_t wr = r < ng ? (uint32_t)w[r] : 0u;
        packed |= ((wr >> (8 * l)) & 0xFFu) << (8 * b);
      }
      Wp[l][q] = packed;
    }
    __syncthreads();

    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int row = wm + mt * 16 + g;
      a[mt][0] = As[row * SROW + t];
      a[mt][1] = As[(row + 8) * SROW + t];
      a[mt][2] = As[row * SROW + 4 + t];
      a[mt][3] = As[(row + 8) * SROW + 4 + t];
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = wn + nt * 8 + g;
      // Occupancy bytes are 0 or 1: times 0xFF gives a byte mask.
      const uint32_t m0 = Bs[col * SROW + t] * 0xFFu;
      const uint32_t m1 = Bs[col * SROW + 4 + t] * 0xFFu;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const uint32_t b0 = m0 & Wp[l][t];
        const uint32_t b1 = m1 & Wp[l][4 + t];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_u8(acc[l][mt][nt], a[mt], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = i0 + wm + mt * 16 + g + half * 8;
        const int col = j0 + wn + nt * 8 + t * 2;
        if (row >= n) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (col + c >= n) continue;
          uint32_t v = 0;
#pragma unroll
          for (int l = 0; l < L; ++l)
            v += (uint32_t)acc[l][mt][nt][half * 2 + c] << (8 * l);
          int32_t* dst = counts + (int64_t)row * n + col + c;
          *dst = (int32_t)((uint32_t)*dst + v);
        }
      }
}

}  // namespace

extern "C" {

// One chunk: counts (n x n, int32) += occ^T diag(w) occ for the chunk's ng
// patterns, whose genome ids are gids[offs[r] .. offs[r+1]) (ids in [0, n)).
// occT is scratch of n_pad x ld bytes, n_pad = n rounded up to 64 and ld =
// ng rounded up to 32; it is zeroed here. Returns cudaGetLastError().
int k1_count_chunk(const int32_t* gids, const int32_t* offs, const int32_t* w,
                   int ng, uint8_t* occT, int64_t ld, int n, int n_pad,
                   int n_limbs, int32_t* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(occT, 0, (size_t)n_pad * ld, s);
  if (err != cudaSuccess) return (int)err;
  scatter_kernel<<<(ng + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, s>>>(
      gids, offs, ng, occT, ld);
  const int k_len = (int)ld;
  dim3 grid(n_pad / TILE, n_pad / TILE);
  switch (n_limbs) {
    case 1:
      count_kernel<1><<<grid, THREADS, 0, s>>>(occT, ld, k_len, w, ng, counts, n);
      break;
    case 2:
      count_kernel<2><<<grid, THREADS, 0, s>>>(occT, ld, k_len, w, ng, counts, n);
      break;
    case 3:
      count_kernel<3><<<grid, THREADS, 0, s>>>(occT, ld, k_len, w, ng, counts, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* vk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
