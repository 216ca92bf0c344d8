// KX: batched forward approximate-match extension.
//
// Replaces the Pallas TPU kernel `_extend_kernel` of the JAX package
// (its ops/extend_pallas.py:68-156, launched by `_run` at :167-184).
// Each job starts at (qi, ri) and compares bases; code 4 never matches and
// positions at or beyond limit = min(nq - qi, nr - ri, CAP) never match. The
// scan stops at the first position whose trailing window of `aw` bases holds
// more than `am` mismatches, or at the limit. The result cuts at the last
// position before that which ends a run of at least `ar` matches (the history
// before the start counts as matches) and returns (cut length, matches up to
// the cut): bit-exact with the TPU kernel and with ops/lz_parse_py._extend.
//
// Bound on an H100 SXM: int32 issue slots, 23 a lane of each warp step of 32
// positions (counted in chip_smoke.py:phase_kx), over the steps the jobs
// need; the distinct code bytes are ~1/75 of that in time. The jobs' windows
// overlap, so 8 bytes a position pass through L2 (808 MB on chip_smoke's
// jobs), which no kernel reading int32 codes avoids; on the card the time
// tracks that traffic (fewer loads in flight, U = 4, ran faster than 8 or 16).
//
// The warp step: 32 positions, one a lane. __ballot_sync gives the match
// mask M; a funnel shift of (previous M, M) gives each lane its last 32
// positions, whose top aw bits (a __popc) decide a violation and top ar bits
// a run end; the first violation is the lowest bit of that ballot, the cut
// the highest run end below it, taken once from the last step that held one;
// each lane counts its own matches, summed across the warp at the end. Needs
// aw <= 32 and ar <= 32 (the wrapper checks), so a range's look-back is the
// one step before it.
//
// The serial chain: one warp walking a job alone spends a memory round trip
// a step (the cap job, 8,192 steps, set the old kernel's 2.9 ms). Every
// quantity at position t depends on the codes at t - 31 .. t only, so a
// range of positions can be summarised on its own: its first violation, its
// last cut before it, the matches up to that cut and its total matches.
// Summaries combine in order: the job stops at the first range with a
// violation, its cut is the last cut up to there, and its matches those of
// the ranges before the cut's range plus the matches up to the cut. Two
// launches a call:
//   A (first_kernel): a warp a job scans positions [0, FIRST). A job that
//     stops there is done; the rest append (job, matches) to a device list.
//   B (rest_kernel): persistent CTAs of WARPS warps take listed jobs one at a
//     time (an atomic counter; the list's length is read on the device, so
//     the host never waits). In round k the warps scan WARPS consecutive
//     sub-ranges of SUB0 << min(k, 3) positions at once and combine them in
//     shared memory; the job stops at the first round that holds a
//     violation or reaches the limit.
// Evaluated beyond what a job needs: at most one round (the doubling keeps a
// round no larger than what came before it) and the rest of one step. Each
// warp issues the loads of the next U steps before the ballots of the
// current ones, so a chain costs one round trip every U steps; a lane's
// loads are one pointer and immediate offsets (an address computed for each
// load cost 13% of the time on the card: tools/kx_probe.py).
// Deterministic: a job is combined by one CTA in a fixed order.
//
// Left for later: reading the codes as bytes or 2-bit packs instead of
// int32, and sharing loads between jobs whose windows overlap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CAP = 1024 * 256;  // SPAN * MAX_BLOCKS of the TPU kernel
constexpr unsigned FULL = 0xFFFFFFFFu;
// Devices a process may launch on (launch state is kept per device).
constexpr int MAX_DEVICES = 64;
constexpr int U = 4;             // steps whose loads are in flight together
constexpr int FIRST = 4096;      // positions launch A scans
constexpr int JOBS_PER_BLOCK = 2;
constexpr int WARPS = 16;        // warps of a launch B CTA
constexpr int SUB0 = 256;        // a warp's sub-range in round 0 ...
constexpr int DOUBLINGS = 3;     // ... doubling up to SUB0 << 3 = 2,048

// What a warp learns of positions [s, e) of one job (positions count from
// the job's start): the first violation, the last cut candidate before it
// (-1: none), the matches in [s, cut] and in [s, e).
struct Summary {
  int viol, cut, mcut, mtot;
};

// The codes of U steps at this lane's position p: qp and rp point at p, so
// each load is the pointer and an immediate offset.
__device__ __forceinline__ void load_steps(const int32_t* __restrict__ qp,
                                           const int32_t* __restrict__ rp,
                                           int p, int e, int (&a)[U],
                                           int (&b)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool in = p + 32 * u < e;
    a[u] = in ? __ldg(qp + 32 * u) : 4;
    b[u] = in ? __ldg(rp + 32 * u) : 4;
  }
}

// Warp-wide (every lane calls it with the same arguments): summarise
// positions [s, e) of the job whose codes start at q and r; s is a multiple
// of 32 and e - s too unless e is the job's limit. Positions before 0 are
// the history (matches).
__device__ Summary scan(const int32_t* __restrict__ q,
                        const int32_t* __restrict__ r, int s, int e, int aw,
                        int am, int ar, int lane) {
  Summary out{-1, -1, 0, 0};
  if (s >= e) return out;
  const uint32_t wtop = FULL << (32 - aw);
  const uint32_t rtop = FULL << (32 - ar);
  const int need = aw - am;  // a window with fewer matches is a violation
  int a[U], b[U], na[U], nb[U];
  int pa = 4, pb = 4;
  if (s > 0) {  // the look-back: the step before s, inside the job
    pa = __ldg(q + s - 32 + lane);
    pb = __ldg(r + s - 32 + lane);
  }
  const int32_t* qp = q + s + lane;
  const int32_t* rp = r + s + lane;
  load_steps(qp, rp, s + lane, e, a, b);
  uint32_t prevM = s > 0 ? __ballot_sync(FULL, pa == pb && pa < 4) : FULL;
  // cnt: this lane's matches so far. The last step that holds a cut
  // candidate is kept (its base, candidates, M and the lane's count before
  // it) and the cut is taken from it once, after the scan.
  int cnt = 0, ok_base = -1, ok_cnt = 0;
  uint32_t ok_mask = 0u, ok_M = 0u;
  for (int base = s; base < e; base += 32 * U) {
    qp += 32 * U;
    rp += 32 * U;
    load_steps(qp, rp, base + 32 * U + lane, e, na, nb);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int bu = base + 32 * u;
      if (bu >= e) goto done;  // the limit, inside a group of U steps
      const uint32_t M = __ballot_sync(FULL, a[u] == b[u] && a[u] < 4);
      // Bit 31 - k of x: position lane - k of this step.
      const uint32_t x = __funnelshift_rc(prevM, M, lane + 1);
      const uint32_t V = __ballot_sync(FULL, __popc(x & wtop) < need);
      const uint32_t R = __ballot_sync(FULL, (x & rtop) == rtop);
      const uint32_t ok = R & (V - 1u) & ~V;
      if (ok) {
        ok_base = bu;
        ok_mask = ok;
        ok_M = M;
        ok_cnt = cnt;
      }
      if (V) {
        out.viol = bu + __ffs(V) - 1;
        goto done;
      }
      cnt += (M >> lane) & 1u;
      prevM = M;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      a[u] = na[u];
      b[u] = nb[u];
    }
  }
done:  // warp sums of the lanes' counts
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    cnt += __shfl_xor_sync(FULL, cnt, o);
    ok_cnt += __shfl_xor_sync(FULL, ok_cnt, o);
  }
  out.mtot = cnt;
  if (ok_base >= 0) {
    const int hi = 31 - __clz(ok_mask);
    out.cut = ok_base + hi;
    out.mcut = ok_cnt + __popc(ok_M & (FULL >> (31 - hi)));
  }
  return out;
}

__device__ __forceinline__ int job_limit(int q0, int r0, int nq, int nr) {
  // A negative start reads nothing and returns (0, 0).
  return (q0 < 0 || r0 < 0) ? 0 : min(min(nq - q0, nr - r0), CAP);
}

// Launch A: a warp a job over [0, FIRST).
__global__ void __launch_bounds__(JOBS_PER_BLOCK * 32)
first_kernel(const int32_t* __restrict__ q, const int32_t* __restrict__ r,
             const int32_t* __restrict__ qi, const int32_t* __restrict__ ri,
             int n_jobs, int nq, int nr, int aw, int am, int ar,
             int32_t* __restrict__ out_len, int32_t* __restrict__ out_match,
             int32_t* __restrict__ list, int32_t* __restrict__ counters) {
  const int job = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (job >= n_jobs) return;  // whole warp: job is warp-uniform
  const int q0 = qi[job], r0 = ri[job];
  const int limit = job_limit(q0, r0, nq, nr);
  const Summary sm = limit > 0 ? scan(q + q0, r + r0, 0, min(limit, FIRST),
                                      aw, am, ar, lane)
                               : Summary{-1, -1, 0, 0};
  if (lane == 0) {
    out_len[job] = sm.cut >= 0 ? sm.cut + 1 : 0;
    out_match[job] = sm.cut >= 0 ? sm.mcut : 0;
    if (sm.viol < 0 && limit > FIRST) {
      const int k = atomicAdd(counters, 1);
      list[2 * k] = job;
      list[2 * k + 1] = sm.mtot;
    }
  }
}

// Launch B: the listed jobs, a CTA a job at a time, in rounds.
__global__ void __launch_bounds__(WARPS * 32)
rest_kernel(const int32_t* __restrict__ q, const int32_t* __restrict__ r,
            const int32_t* __restrict__ qi, const int32_t* __restrict__ ri,
            int nq, int nr, int aw, int am, int ar,
            int32_t* __restrict__ out_len, int32_t* __restrict__ out_match,
            const int32_t* __restrict__ list, int32_t* __restrict__ counters) {
  __shared__ Summary sums[WARPS];
  __shared__ int s_item;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int listed = counters[0];
  for (;;) {
    if (threadIdx.x == 0) s_item = atomicAdd(counters + 1, 1);
    __syncthreads();
    const int item = s_item;
    if (item >= listed) return;  // CTA-uniform
    const int job = list[2 * item];
    int carry = list[2 * item + 1];  // matches in [0, pos)
    const int q0 = qi[job], r0 = ri[job];
    const int limit = job_limit(q0, r0, nq, nr);
    int best_cut = out_len[job], best_match = out_match[job];
    int pos = FIRST;
    for (int k = 0;; ++k) {
      const int sub = SUB0 << min(k, DOUBLINGS);
      const int s = pos + warp * sub;
      const Summary sm = scan(q + q0, r + r0, s, min(s + sub, limit), aw, am,
                              ar, lane);
      if (lane == 0) sums[warp] = sm;
      __syncthreads();
      bool stop = false;
      for (int w = 0; w < WARPS && !stop; ++w) {
        const Summary t = sums[w];
        if (t.cut >= 0) {
          best_cut = t.cut + 1;
          best_match = carry + t.mcut;
        }
        stop = t.viol >= 0;
        carry += t.mtot;
      }
      pos += WARPS * sub;
      __syncthreads();  // sums and s_item are rewritten next
      if (stop || pos >= limit) break;
    }
    if (threadIdx.x == 0) {
      out_len[job] = best_cut;
      out_match[job] = best_match;
    }
  }
}

}  // namespace

extern "C" {

// q, r: int32 codes (values 0..4); qi, ri: int32 job starts; outputs int32
// per job; scratch: 2 * n_jobs + 2 int32 (the list of jobs launch A leaves
// and two counters). Launches A then B on `stream`. Returns
// cudaGetLastError().
int kx_extend(const int32_t* q, const int32_t* r, const int32_t* qi,
              const int32_t* ri, int n_jobs, int nq, int nr, int aw, int am,
              int ar, int32_t* out_len, int32_t* out_match, int32_t* scratch,
              void* stream) {
  static int grid_b_of[MAX_DEVICES] = {};  // launch B's CTAs, per device
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int& grid_b = grid_b_of[dev];
  if (grid_b == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rest_kernel,
                                                  WARPS * 32, 0);
    grid_b = sms * (per_sm > 0 ? per_sm : 1);
  }
  int32_t* counters = scratch + 2 * n_jobs;
  cudaMemsetAsync(counters, 0, 2 * sizeof(int32_t), s);
  const int blocks = (n_jobs + JOBS_PER_BLOCK - 1) / JOBS_PER_BLOCK;
  first_kernel<<<blocks, JOBS_PER_BLOCK * 32, 0, s>>>(
      q, r, qi, ri, n_jobs, nq, nr, aw, am, ar, out_len, out_match, scratch,
      counters);
  rest_kernel<<<grid_b, WARPS * 32, 0, s>>>(q, r, qi, ri, nq, nr, aw, am, ar,
                                            out_len, out_match, scratch,
                                            counters);
  return (int)cudaGetLastError();
}

const char* vk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
