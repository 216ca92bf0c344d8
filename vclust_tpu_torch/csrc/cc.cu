// K11: connected components of an edge list, each node labelled with the
// least member index of its component.
//
// Replaces `_cc_run` of the JAX package (its ops/cc.py:21-44), the
// min-label propagation that single linkage runs from 50,000 objects up
// (models/cluster.py:_single). The labels are exactly that program's and
// the host union-find's: bit for bit, there is no tolerance.
//
// Bound on an H100 SXM: bytes. The least work reads the int32 edges once
// (8 bytes an edge) and writes the int32 labels once (4 bytes a node): at 2 M
// nodes and 8 M edges 72 MB, 0.021 ms at 3.35 TB/s. The propagation needs
// rounds that depend on the graph (60,403 on a 200,000-node path whose ids
// are permuted), each a pass over the edges and a host read of a flag. This
// kernel does no rounds: it is union-find on the edge list (ECL-CC's hooking
// with path halving), three launches whatever the graph, and nothing read
// back to the host between them. Its other traffic is `parent`, read and
// written at random: 4 bytes a node, which stays in the 50 MB L2 up to ~12 M
// nodes, so the edges' one pass over device memory is what the bound counts.
//
// The launches (the output `labels` is the union-find's `parent` array):
//   init:    parent[v] = v.
//   hook:    a thread an edge (a grid-stride loop): find both roots, halving
//            the path with plain stores; while they differ, CAS the larger
//            root's parent from itself to the smaller root, and on failure
//            find again from what the CAS saw.
//   flatten: parent[v] = the root of v, found without stores (each node's
//            label is written once, by its own thread).
// Why the root of each component is its least member, whatever order the
// atomics take: a root is only ever linked under a smaller root, and halving
// only points a node at one of its ancestors, so parent[x] <= x always
// holds and no cycle can form; the least member m of a component can only
// point at a member no larger than itself, so it stays a root, and once
// every edge is hooked each component is one tree.
// Memory: parent is read by plain (L1-cached) loads. A stale read returns
// an older parent, which is an ancestor all the same: a find may stop at a
// node that was a root once, but two endpoints that meet at one root were
// in one tree then and stay so, and a CAS on a stale root fails and hands
// back the parent it found, fresh from L2. The roots of large trees are
// read by every find, and L1 serves them: ld.global.cg (L2 only) in place
// of the plain loads takes 1.7× the time on 8 M random edges and 1.4× on
// 1.5 M edges < 64 apart (tools/k11_probe.py, variant `ld_cg`).
// Caps: every step of a find lowers the node id, and every failed CAS
// lowers the larger root (the next finds start from what it saw and from
// the smaller root, and no read returns a parent above the node), so
// neither loop can take more than n turns; a loop that does has met a
// cycle (a bug) and traps instead of hanging the card. No state passes
// between CTAs except through the atomics on parent.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// CTAs of a grid-stride launch at most: ~2 edges a thread at 8 M edges.
// The hook's finds wait on dependent loads; tools/k11_probe.py times other
// caps (`ctas_*`, `ctas_unbounded`: a thread an item).
constexpr long long MAX_CTAS = 132 * 128;

__device__ __forceinline__ int load_parent(const int* parent, int x) {
  return parent[x];
}

// The root of x, halving the path: each node passed is pointed at its
// grandparent (a plain store: the grandparent is an ancestor, whatever
// other threads store there meanwhile; without these stores K11 takes
// 1.1× the time on 8 M random edges: the probe's `no_halving`).
__device__ __forceinline__ int find_root(int* parent, int x, int n) {
  for (int steps = 0;; ++steps) {
    const int p = load_parent(parent, x);
    if (p == x) return x;
    const int gp = load_parent(parent, p);
    if (gp != p) parent[x] = gp;
    x = gp;
    if (steps > n) __trap();  // ids fall every step: a cycle
  }
}

// The root of x, read only: the flatten launch stores nothing on the way,
// since a halving store there could put an ancestor back over a node's
// finished label.
__device__ __forceinline__ int walk_root(const int* parent, int x, int n) {
  for (int steps = 0;; ++steps) {
    const int p = load_parent(parent, x);
    if (p == x) return x;
    x = p;
    if (steps > n) __trap();
  }
}

__global__ void __launch_bounds__(THREADS) cc_init(int* parent, int n) {
  for (long long v = blockIdx.x * (long long)THREADS + threadIdx.x; v < n;
       v += (long long)gridDim.x * THREADS)
    parent[v] = (int)v;
}

__global__ void __launch_bounds__(THREADS)
    cc_hook(const int* __restrict__ edges, long long E, int* parent, int n) {
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < E;
       i += (long long)gridDim.x * THREADS) {
    const int a = __ldg(edges + 2 * i), b = __ldg(edges + 2 * i + 1);
    if (a == b) continue;
    int ra = find_root(parent, a, n), rb = find_root(parent, b, n);
    for (int tries = 0; ra != rb; ++tries) {
      const int lo = min(ra, rb), hi = max(ra, rb);
      const int seen = atomicCAS(parent + hi, hi, lo);
      if (seen == hi) break;
      // hi was linked under seen < hi meanwhile: the larger root falls.
      if (tries > n) __trap();
      ra = find_root(parent, seen, n);
      rb = find_root(parent, lo, n);
    }
  }
}

__global__ void __launch_bounds__(THREADS) cc_flatten(int* parent, int n) {
  for (long long v = blockIdx.x * (long long)THREADS + threadIdx.x; v < n;
       v += (long long)gridDim.x * THREADS)
    parent[v] = walk_root(parent, (int)v, n);
}

unsigned ctas(long long items) {
  const long long c = (items + THREADS - 1) / THREADS;
  return (unsigned)(c < MAX_CTAS ? c : MAX_CTAS);
}

}  // namespace

extern "C" {

// K11 on `stream`: labels (n int32) from edges (E x 2 int32, every id in
// [0, n), checked by the caller). Allocates nothing; returns
// cudaGetLastError() after the launches.
int k11_cc(const int* edges, long long E, int n, int* labels,
           cudaStream_t stream) {
  if (n > 0) {
    cc_init<<<ctas(n), THREADS, 0, stream>>>(labels, n);
    if (E > 0) cc_hook<<<ctas(E), THREADS, 0, stream>>>(edges, E, labels, n);
    cc_flatten<<<ctas(n), THREADS, 0, stream>>>(labels, n);
  }
  return cudaGetLastError();
}

const char* vk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
