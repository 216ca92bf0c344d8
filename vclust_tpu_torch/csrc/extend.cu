// KX: batched forward approximate-match extension.
//
// Replaces the Pallas TPU kernel `_extend_kernel` of the JAX package
// (its ops/extend_pallas.py:68-156, launched by `_run` at :167-184).
// Each job starts at (qi, ri) and compares bases; code 4 never matches and
// positions at or beyond max_len = min(nq - qi, nr - ri) never match. The scan
// stops at the first position whose trailing window of `aw` bases holds more
// than `am` mismatches, or after CAP bases. The result cuts at the last
// position before that which ends a run of at least `ar` matches (the history
// before the start counts as matches) and returns (cut length, matches up to
// the cut): bit-exact with the TPU kernel and with ops/lz_parse_py._extend.
//
// Design: one warp per job, 8 jobs per block. Each step compares 32 bases,
// one per lane. __ballot_sync gives the match mask M and mismatch mask F; the
// window count of a lane is a __popc over the previous step's F and this one
// taken together as 64 bits; __ffs of the violation ballot gives the first
// violation; the run-of-ar test is shifted ANDs of the 64-bit match history;
// the cut is the highest qualifying lane below the first violation, and its
// match count a __popc. Needs aw <= 32 and ar <= 32 (the wrapper checks).
//
// Bound on an H100 SXM: the bytes of codes the jobs read (4 bytes a base, two
// sequences) against 3.35 TB/s. Left for later: reading the codes as bytes or
// 2-bit packs instead of int32, and sharing a block's loads between jobs whose
// windows overlap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CAP = 1024 * 256;  // SPAN * MAX_BLOCKS of the TPU kernel
constexpr int JOBS_PER_BLOCK = 8;
constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void __launch_bounds__(JOBS_PER_BLOCK * 32)
extend_kernel(const int32_t* __restrict__ q, const int32_t* __restrict__ r,
              const int32_t* __restrict__ qi, const int32_t* __restrict__ ri,
              int n_jobs, int nq, int nr, int aw, int am, int ar,
              int32_t* __restrict__ out_len, int32_t* __restrict__ out_match) {
  const int job = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (job >= n_jobs) return;  // whole warp: job is warp-uniform
  const int q0 = qi[job], r0 = ri[job];
  // A negative start reads nothing and returns (0, 0).
  const int limit = (q0 < 0 || r0 < 0) ? 0 : min(min(nq - q0, nr - r0), CAP);
  const uint64_t wmask = (1ull << aw) - 1ull;
  const int wshift = lane + 33 - aw;  // window of lane: bits 32+lane-aw+1 ..

  uint32_t prevF = 0u, prevM = FULL;  // history: no mismatches, all matches
  int match_carry = 0, best_cut = 0, best_match = 0;
  for (int base = 0; base < limit; base += 32) {
    const int p = base + lane;
    bool m = false;
    if (p < limit) {
      const int a = q[q0 + p];
      m = (a == r[r0 + p]) && a < 4;
    }
    const uint32_t M = __ballot_sync(FULL, m);
    const uint32_t F = ~M;
    const uint64_t f64 = ((uint64_t)F << 32) | prevF;
    const int mism = __popcll((f64 >> wshift) & wmask);
    const uint32_t V = __ballot_sync(FULL, mism > am);
    const int fv = V ? __ffs(V) - 1 : 32;
    const uint64_t m64 = ((uint64_t)M << 32) | prevM;
    uint64_t run = m64;
    for (int k = 1; k < ar; ++k) run &= m64 << k;
    const int rem = limit - base;
    const uint32_t valid = rem >= 32 ? FULL : ((1u << rem) - 1u);
    const uint32_t before = fv == 32 ? FULL : ((1u << fv) - 1u);
    const uint32_t ok = (uint32_t)(run >> 32) & valid & before;
    if (ok) {
      const int cut = 31 - __clz(ok);
      const uint32_t upto = cut == 31 ? FULL : ((2u << cut) - 1u);
      best_cut = base + cut + 1;
      best_match = match_carry + __popc(M & upto);
    }
    if (V) break;
    match_carry += __popc(M);
    prevF = F;
    prevM = M;
  }
  if (lane == 0) {
    out_len[job] = best_cut;
    out_match[job] = best_match;
  }
}

}  // namespace

extern "C" {

// q, r: int32 codes (values 0..4); qi, ri: int32 job starts; outputs
// int32 per job. Returns cudaGetLastError().
int kx_extend(const int32_t* q, const int32_t* r, const int32_t* qi,
              const int32_t* ri, int n_jobs, int nq, int nr, int aw, int am,
              int ar, int32_t* out_len, int32_t* out_match, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n_jobs + JOBS_PER_BLOCK - 1) / JOBS_PER_BLOCK;
  extend_kernel<<<blocks, JOBS_PER_BLOCK * 32, 0, s>>>(
      q, r, qi, ri, n_jobs, nq, nr, aw, am, ar, out_len, out_match);
  return (int)cudaGetLastError();
}

const char* vk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
