// K11: connected components of an edge list, each node labelled with the
// least member index of its component.
//
// Replaces `_cc_run` of the JAX package (its ops/cc.py:21-44), the
// min-label propagation that single linkage runs from 50,000 objects up
// (models/cluster.py:_single). The labels are exactly that program's and
// the host union-find's: bit for bit, there is no tolerance.
//
// Bound on an H100 SXM: bytes. The least work reads the int32 edges once
// (8 bytes an edge) and writes the int32 labels once (4 bytes a node):
// (8E + 4n) / 3.35 TB/s, 0.021 ms at 2 M nodes and 8 M edges, 0.134 ms at
// 16 M nodes and 48 M edges. The propagation needs rounds that depend on
// the graph (48,823 on a 200,000-node path whose ids are permuted), each a
// pass over the edges and a host read of a flag. This kernel does no
// rounds: it is union-find on the edge list (ECL-CC's hooking with path
// halving) with Afforest's sample-then-skip (Sutton et al., IPDPS 2018)
// adapted to an edge list, and nothing is read back to the host between
// its launches. Its other traffic is `parent` (the labels), read and
// written at random: 8 MB at 2 M nodes fits the 50 MB L2, 64 MB at 16 M
// nodes does not. The edges are loaded with an evict-first hint
// (ld.global.cs), and where their bytes exceed L2 an access-policy window
// keeps `parent` in L2's persisting part while they stream past.
//
// The launches:
//   init:     parent[v] = v.
//   hook:     a warp a block of 32 edges, a lane one edge: the roots of its
//             two ends are found with their chains walked in step; then
//             the warp unites its lanes' pairs (below).
//   flatten:  parent[v] = the root of v, walked without stores (each
//             node's label is written once, by its own thread).
// With E >= 2n edges the hook runs twice. First on a sample: every s-th
// block, s = E / n, so about n edges spread over the whole list (`cluster`
// sorts its edges by their smaller end, so a prefix would link only low
// ids). Then `compress` (the flatten's code) points every node at its
// root, and the hook runs on the other blocks, where each lane replaces
// both ends of its edge by their parents before anything else: ends that
// read one parent owe nothing, as a self loop. On a graph with a giant
// component most edges fall inside it once the sample has built it, and
// cost two loads and no CAS. (Afforest skips a node whose parent is the
// giant root L; on an edge list every edge is read anyway, and the test
// "both ends read one parent" catches every edge that "both read L" does,
// at the same two loads, with no L to choose.) The finds halve paths
// only where the hook runs once over every edge.
// Uniting in a warp: where two neighbouring lanes owe a union under one
// larger root `hi` (a star, or sorted edges that share an end), the lanes
// whose hi is the same (__match_any_sync) elect the one with the least
// smaller root `lo_min` (__reduce_min_sync), and only it CASes parent[hi]
// from hi to lo_min. On success each other lane of the group still owes
// (its lo, lo_min); on failure each goes on from (what the CAS saw, its
// lo). Then every lane CASes its own pair's larger root under the smaller
// until its pair is united, finding both roots again after a failed CAS.
// A star sends the shared root one CAS a warp in place of 32. The
// election's collectives take the full mask: every lane of a warp runs
// the block loop together and reaches them before its own loop, and lanes
// that owe nothing join them with the key -1.
//
// Why the root of each component is its least member, whatever order the
// atomics take: a root is only ever linked under a smaller id, halving only
// points a node at one of its ancestors and the flatten at its root, so
// parent[x] <= x always holds and no cycle can form; the least member m of
// a component can only point at a member no larger than itself, so it
// stays a root, and once every edge is united each component is one tree.
// Memory: parent is read by plain (L1-cached) loads, which other SMs'
// stores do not update. A stale read returns an older parent, which is an
// ancestor all the same: a find may stop at a node that was a root once,
// but two ends that meet at one root were in one tree then and stay so; two
// ends that read one parent share that ancestor, so the skip is exact on
// any read; a CAS on a stale root fails and hands back the parent it
// found, fresh from L2. The compress and the flatten store what they read
// (a node's root), so a stale read there is not harmless: read as its own
// parent from an older line, a node would be made a root again and its
// subtree cut off. They are exact because each is a launch of its own:
// L1 starts every launch empty, no hook runs beside them, and a location
// whose value since the launch began is its own id is a root. (Inside one
// persistent launch both would have to read through L2, __ldcg, or after
// an acquire at GPU scope: an L1 line left from the hook could show a
// former root as a root. tools/k11_probe.py's `persistent` variant reads
// through L2.)
// Caps: every step of a find lowers the node id, and every turn of a lane
// in a union lowers its larger root: after the election the pair it still
// owes is (lo, lo_min) or (seen, lo), after a failed CAS (seen, lo), all
// below hi (no read returns a parent above its node). So neither loop can
// take more than n turns; a loop that does has met a cycle (a bug) and
// traps instead of hanging the card. No state passes between CTAs except
// through the atomics on parent, and none between calls.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
// A warp's step: 32 edges, one 8-byte load a lane.
constexpr long long BLOCK_EDGES = 32;
// The sample is about SAMPLE_PER_NODE * n edges, every s-th block; where
// s would be below 2 (E < 2n at 1.0) the hook runs once over every edge.
constexpr double SAMPLE_PER_NODE = 1.0;
// CTAs of a grid-stride launch at most. tools/k11_probe.py times other
// caps (`ctas_*`).
constexpr long long MAX_CTAS = 132 * 128;
// Where the edges' bytes exceed L2, `parent` is kept in L2's persisting
// part while they stream past (tools/k11_probe.py: `no_l2_window`).
constexpr bool L2_WINDOW = true;

// The blocks a hook launch takes: every one, every s-th (the sample), or
// the others.
constexpr int ALL = 0, SAMPLE = 1, REST = 2;

template <int PHASE>
__device__ __forceinline__ long long block_of(long long k, long long s) {
  if (PHASE == ALL) return k;
  if (PHASE == SAMPLE) return k * s;
  return k / (s - 1) * s + k % (s - 1) + 1;
}

// The roots of x[0] and x[1] for the chains marked in `live`, walked in
// step (their loads in flight together), with HALVE halving each path with
// plain stores: each node passed is pointed at its grandparent, an
// ancestor whatever other threads store there meanwhile.
template <bool HALVE>
__device__ __forceinline__ void find_roots(int* parent, int (&x)[2],
                                           unsigned live, int n) {
  for (int steps = 0; live; ++steps) {
    int p[2], gp[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) p[k] = live >> k & 1 ? parent[x[k]] : x[k];
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (p[k] == x[k]) live &= ~(1u << k);
#pragma unroll
    for (int k = 0; k < 2; ++k) gp[k] = live >> k & 1 ? parent[p[k]] : x[k];
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (live >> k & 1) {
        if (HALVE && gp[k] != p[k]) parent[x[k]] = gp[k];
        x[k] = gp[k];
      }
    if (steps > n) __trap();  // ids fall every step: a cycle
  }
}

// Unites each lane's pair of roots r (equal when the lane owes nothing).
// All 32 lanes call it together. Where two neighbouring lanes owe a union
// under one larger root (a star, or sorted edges that share an end), the
// warp first elects: the lanes whose larger root `hi` is the same elect
// the one with the least smaller root, which alone CASes parent[hi]; each
// other lane of the group goes on from the union it still owes. Then every
// lane CASes its own pair's larger root until its pair is united.
template <bool HALVE>
__device__ __forceinline__ void unite(int* parent, int (&r)[2], int lane,
                                      int n) {
  const bool owe = r[0] != r[1];
  const int lo = min(r[0], r[1]), hi = max(r[0], r[1]);
  const int key = owe ? hi : -1;  // no id is negative
  const int left = __shfl_up_sync(FULL, key, 1);
  if (__any_sync(FULL, owe && lane > 0 && left == key)) {
    const unsigned group = __match_any_sync(FULL, key);
    const int lo_min = __reduce_min_sync(group, lo);
    const int leader = __ffs(group & __ballot_sync(FULL, lo == lo_min)) - 1;
    int seen = hi;
    if (owe && lane == leader) seen = atomicCAS(parent + hi, hi, lo_min);
    seen = __shfl_sync(FULL, seen, leader);
    if (owe) {
      // On success hi hangs under lo_min, and (lo, lo_min) is still owed;
      // on failure hi was linked under seen < hi meanwhile.
      r[0] = seen == hi ? lo : seen;
      r[1] = seen == hi ? lo_min : lo;
      find_roots<HALVE>(parent, r, r[0] != r[1] ? 3u : 0u, n);
    }
  }
  for (int tries = 0; r[0] != r[1]; ++tries) {
    if (tries > n) __trap();  // the larger root falls every turn
    const int a = min(r[0], r[1]), b = max(r[0], r[1]);
    const int seen = atomicCAS(parent + b, b, a);
    if (seen == b) return;
    r[0] = seen;  // b was linked under seen < b meanwhile
    r[1] = a;
    find_roots<HALVE>(parent, r, 3u, n);
  }
}

__global__ void __launch_bounds__(THREADS) cc_init(int* parent, int n) {
  for (long long v = blockIdx.x * (long long)THREADS + threadIdx.x; v < n;
       v += (long long)gridDim.x * THREADS)
    parent[v] = (int)v;
}

// `steps` blocks of PHASE, a warp a block; s the sample's stride. Halving
// pays where the hook runs once over every edge (the chains of edges
// between near ids); in the sample and the other blocks its stores cost
// more than they save (tools/k11_probe.py: `halve_always`).
template <int PHASE>
__global__ void __launch_bounds__(THREADS)
    cc_hook(const int* __restrict__ edges, long long E, long long steps,
            long long s, int* parent, int n) {
  constexpr bool HALVE = PHASE == ALL;
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (THREADS / 32);
  for (long long k = (blockIdx.x * (long long)THREADS + threadIdx.x) / 32;
       k < steps; k += warps) {
    const long long e = block_of<PHASE>(k, s) * BLOCK_EDGES + lane;
    int x[2] = {0, 0};  // equal ends owe nothing
    if (e < E) {
      const int2 v = __ldcs(reinterpret_cast<const int2*>(edges) + e);
      x[0] = v.x, x[1] = v.y;
    }
    if (PHASE == REST) {
      // The skip: each end replaced by its parent, an ancestor with the
      // same root.
      x[0] = parent[x[0]], x[1] = parent[x[1]];
    }
    find_roots<HALVE>(parent, x, x[0] != x[1] ? 3u : 0u, n);
    unite<HALVE>(parent, x, lane, n);
  }
}

// The root of x, read only: a halving store here could put an ancestor
// back over a node's finished label.
__device__ __forceinline__ int walk_root(const int* parent, int x, int n) {
  for (int steps = 0;; ++steps) {
    const int p = parent[x];
    if (p == x) return x;
    x = p;
    if (steps > n) __trap();
  }
}

__device__ __forceinline__ void point_at_roots(int* parent, int n) {
  for (long long v = blockIdx.x * (long long)THREADS + threadIdx.x; v < n;
       v += (long long)gridDim.x * THREADS)
    parent[v] = walk_root(parent, (int)v, n);
}

// After the sample: every node pointed at its root, so that the other
// blocks' ends read their roots in one load.
__global__ void __launch_bounds__(THREADS) cc_compress(int* parent, int n) {
  point_at_roots(parent, n);
}

__global__ void __launch_bounds__(THREADS) cc_flatten(int* parent, int n) {
  point_at_roots(parent, n);
}

long long sample_stride(long long E, int n) {
  return (long long)(E / (SAMPLE_PER_NODE * n));
}

unsigned ctas(long long threads) {
  const long long c = (threads + THREADS - 1) / THREADS;
  return (unsigned)(c < MAX_CTAS ? c : MAX_CTAS);
}

void launch(const int* edges, long long E, int n, int* labels,
            cudaStream_t stream) {
  cc_init<<<ctas(n), THREADS, 0, stream>>>(labels, n);
  const long long blocks = (E + BLOCK_EDGES - 1) / BLOCK_EDGES;
  const long long s = sample_stride(E, n);
  if (s >= 2) {
    const long long sample = (blocks + s - 1) / s, rest = blocks - sample;
    cc_hook<SAMPLE><<<ctas(32 * sample), THREADS, 0, stream>>>(
        edges, E, sample, s, labels, n);
    if (rest > 0) {
      cc_compress<<<ctas(n), THREADS, 0, stream>>>(labels, n);
      cc_hook<REST><<<ctas(32 * rest), THREADS, 0, stream>>>(
          edges, E, rest, s, labels, n);
    }
  } else if (E > 0) {
    cc_hook<ALL><<<ctas(32 * blocks), THREADS, 0, stream>>>(
        edges, E, blocks, 1, labels, n);
  }
  cc_flatten<<<ctas(n), THREADS, 0, stream>>>(labels, n);
}

// The launches inside an access-policy window over `parent` (at most the
// card's largest window), its lines persisting in L2's set-aside (made the
// card's largest at a device's first window); after them the window is
// taken off the stream and the lines made normal again.
void launch_in_window(const int* edges, long long E, int n, int* labels,
                      cudaStream_t stream, int dev) {
  static unsigned long long limit_set = 0;  // a bit a device
  int persist = 0, window = 0;
  cudaDeviceGetAttribute(&persist, cudaDevAttrMaxPersistingL2CacheSize, dev);
  cudaDeviceGetAttribute(&window, cudaDevAttrMaxAccessPolicyWindowSize, dev);
  if (dev < 64 && !(limit_set >> dev & 1)) {
    cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, (size_t)persist);
    limit_set |= 1ull << dev;
  }
  const size_t want = (size_t)n * sizeof(int);
  const size_t bytes = want < (size_t)window ? want : (size_t)window;
  cudaStreamAttrValue a = {};
  a.accessPolicyWindow.base_ptr = labels;
  a.accessPolicyWindow.num_bytes = bytes;
  a.accessPolicyWindow.hitRatio = fminf(1.f, (float)persist / (float)bytes);
  a.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
  a.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
  cudaStreamSetAttribute(stream, cudaStreamAttributeAccessPolicyWindow, &a);
  launch(edges, E, n, labels, stream);
  a.accessPolicyWindow.num_bytes = 0;
  cudaStreamSetAttribute(stream, cudaStreamAttributeAccessPolicyWindow, &a);
  cudaCtxResetPersistingL2Cache();
}

}  // namespace

extern "C" {

// K11 on `stream`: labels (n int32) from edges (E x 2 int32, 8-byte
// aligned, every id in [0, n), both checked by the caller). Allocates
// nothing; returns cudaGetLastError() after the launches.
int k11_cc(const int* edges, long long E, int n, int* labels,
           cudaStream_t stream) {
  if (n <= 0) return cudaGetLastError();
  int dev = 0, l2 = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
  if (L2_WINDOW && 8 * E > l2)
    launch_in_window(edges, E, n, labels, stream, dev);
  else
    launch(edges, E, n, labels, stream);
  return cudaGetLastError();
}

const char* vk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
