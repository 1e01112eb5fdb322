// G1 point kernels over projective Montgomery batches (24, ...) x3:
// elementwise addition r_i = p_i + q_i and doubling r_i = 2 p_i, and the
// halving tree that sums each set of a batch in one launch.
//
// Replaces: the padd tree of _reduce_partials (baby_plonk_tpu/ops/
// pallas_kernels.py:138-156) and g1_vec.tree_reduce (ops/g1_vec.py:298),
// which the fixed-base Pallas MSM ran in XLA after its kernel, and
// msm._combine_partials (ops/msm.py:101-116) across chunks: bpt_g1_tree. The
// XLA elementwise g1_vec.padd / g1_vec.pdouble (ops/g1_vec.py:132, :165):
// bpt_g1_padd, bpt_g1_pdouble. They were the steps of the Pippenger scans
// until that MSM got kernels of its own (csrc/pippenger.cu); the doubling
// runs the SRS's chain of multiples.
//
// Bound on this card: the 12 Fq Montgomery products per addition (8 per
// doubling) on the integer multiply-add pipe; an addition reads 6 and
// writes 3 coordinates of 96 bytes per lane, a doubling reads 3 and writes 3.
// The tree of a set of n lanes does n - 1 additions over log2(n) levels,
// each level dependent on the one before: its floor is log2(n) times the
// latency of one addition (a chain of Montgomery products on one thread),
// far above its bytes or its multiply-adds at the prove's shapes.
//
// Addition and doubling: one thread a lane.
//
// The tree's design. Level s adds lane i + n/2^(s+1) into lane i (i below
// that offset), the order of the plain loop, so the sum is the plain
// version's, limb for limb. A thread holds two points and the formula's
// temporaries: ptxas gives the kernel 248 registers, no stack, no spills
// (kernels.resource_usage("g1.cu")), so a block is at most TREE_THREADS = 256
// threads, one resident an SM, and a block of 128 threads two. Shared
// memory: one point a thread, word-major, 144 bytes (18 KB at 128 threads,
// 36 KB at 256: no opt-in). ops/g1_vec.py::tree_plan cuts the launch:
//   - B blocks a set, B a power of two: block b takes the lanes b + k B, a
//     set that the first log2(n / B) levels pair only within itself (their
//     offsets are multiples of B). Its thread u loads lanes u and u + m/2 of
//     those m = n / B and adds them (the first level, in registers), then
//     the block runs the next log2(m / 2) levels in shared memory, and ends
//     with lane b of the set after log2(m) levels;
//   - with B > 1, each block writes that point to a scratch slot, fences,
//     and takes a ticket from its set's counter (zeroed before the launch);
//     the set's last block reads the B points and runs the last log2(B)
//     levels the same way. B grows until the sets fill the card's SMs, so
//     the main path's 24 sets of 2,048 lanes run as 192 blocks of 128
//     threads, not on 24 SMs at 4 additions a thread a level;
//   - with B = 1 and short sets, a block takes several sets, U = n/2
//     threads each (the combine's (24, P, W, 8) is one block);
//   - the input is read where the caller's view puts it: limb stride, lane
//     stride, and a set offset of up to two batch strides (the fixed-base
//     MSM's (24, P, W, full, 2048) view of its partials is not copied).

#include "g1.cuh"

using namespace bpt;

namespace {

__global__ void g1_padd_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
                               const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
                               const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
                               int32_t* x3, int32_t* y3, int32_t* z3, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    G1P p, q;
    g1_load(p, x1, y1, z1, i, n);
    g1_load(q, x2, y2, z2, i, n);
    g1_add(p, q);
    g1_store(x3, y3, z3, i, n, p);
  }
}

__global__ void g1_pdouble_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
                                  const int32_t* __restrict__ z1, int32_t* x3, int32_t* y3,
                                  int32_t* z3, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    G1P p;
    g1_load(p, x1, y1, z1, i, n);
    g1_double(p);
    g1_store(x3, y3, z3, i, n, p);
  }
}

constexpr int TREE_THREADS = 256;

// One bpt_g1_tree launch. Set s starts at element (s / inner) outer_stride +
// (s % inner) inner_stride of each coordinate; lane k of it at k lane_stride
// further, limb l at l limb_stride.
struct TreeArgs {
  const int32_t *x, *y, *z;
  int64_t limb_stride, lane_stride, inner, outer_stride, inner_stride;
  int64_t sets, n;
  int32_t *ox, *oy, *oz;  // (24, sets)
  uint32_t* part;         // (36, sets B) words: each block's point, B > 1
  unsigned* count;        // (sets): blocks of a set done, B > 1
  int B, units, U;        // blocks a set, sets a block (B = 1), threads a unit
};

__global__ void __launch_bounds__(TREE_THREADS) g1_tree_kernel(TreeArgs a) {
  extern __shared__ uint32_t sm[];
  const int tid = threadIdx.x;
  const int64_t m = a.n / a.B;
  int64_t set;
  int b, u;
  bool active;
  if (a.B == 1) {
    set = (int64_t)blockIdx.x * a.units + tid / a.U;
    b = 0;
    u = tid % a.U;
    active = set < a.sets;
  } else {
    set = blockIdx.x / a.B;
    b = blockIdx.x % a.B;
    u = tid;
    active = u < a.U;
  }
  G1P acc, q;
  g1_identity(acc);
  if (active) {
    const int64_t base = (set / a.inner) * a.outer_stride + (set % a.inner) * a.inner_stride;
    g1_load(acc, a.x, a.y, a.z, base + (b + (int64_t)u * a.B) * a.lane_stride, a.limb_stride);
    if (m > 1) {
      g1_load(q, a.x, a.y, a.z, base + (b + (int64_t)(u + m / 2) * a.B) * a.lane_stride, a.limb_stride);
      g1_add(acc, q);
    }
  }
  g1_smem_tree(acc, q, sm, a.U, active);
  if (a.B == 1) {
    if (active && u == 0) g1_store(a.ox, a.oy, a.oz, set, a.sets, acc);
    return;
  }

  __shared__ bool last;
  const int64_t slots = a.sets * a.B;
  if (tid == 0) {
    const int64_t slot = set * a.B + b;
#pragma unroll
    for (int w = 0; w < 12; w++) {
      a.part[w * slots + slot] = acc.x[w];
      a.part[(12 + w) * slots + slot] = acc.y[w];
      a.part[(24 + w) * slots + slot] = acc.z[w];
    }
    __threadfence();  // the point is visible on the card before the ticket
    last = atomicAdd(&a.count[set], 1u) == (unsigned)(a.B - 1);
  }
  __syncthreads();
  if (!last) return;

  // the set's last block: its B points through the last log2(B) levels
  const int H = a.B / 2;
  const bool active2 = tid < H;
  if (active2) {
    const int64_t s0 = set * a.B + tid, s1 = s0 + H;
#pragma unroll
    for (int w = 0; w < 12; w++) {  // past L1: other blocks wrote them
      acc.x[w] = __ldcg(&a.part[w * slots + s0]);
      acc.y[w] = __ldcg(&a.part[(12 + w) * slots + s0]);
      acc.z[w] = __ldcg(&a.part[(24 + w) * slots + s0]);
      q.x[w] = __ldcg(&a.part[w * slots + s1]);
      q.y[w] = __ldcg(&a.part[(12 + w) * slots + s1]);
      q.z[w] = __ldcg(&a.part[(24 + w) * slots + s1]);
    }
    g1_add(acc, q);
  }
  g1_smem_tree(acc, q, sm, H, active2);
  if (tid == 0) g1_store(a.ox, a.oy, a.oz, set, a.sets, acc);
}

}  // namespace

extern "C" int bpt_g1_padd(const void* x1, const void* y1, const void* z1, const void* x2,
                           const void* y2, const void* z2, void* x3, void* y3, void* z3,
                           long long n, void* stream) {
  const int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65536) blocks = 65536;
  g1_padd_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x1, (const int32_t*)y1, (const int32_t*)z1, (const int32_t*)x2,
      (const int32_t*)y2, (const int32_t*)z2, (int32_t*)x3, (int32_t*)y3, (int32_t*)z3, n);
  return (int)cudaGetLastError();
}

extern "C" int bpt_g1_pdouble(const void* x1, const void* y1, const void* z1, void* x3, void* y3,
                              void* z3, long long n, void* stream) {
  const int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65536) blocks = 65536;
  g1_pdouble_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x1, (const int32_t*)y1, (const int32_t*)z1, (int32_t*)x3, (int32_t*)y3,
      (int32_t*)z3, n);
  return (int)cudaGetLastError();
}

// Each set of a (24, sets, n) batch -> its sum (24, sets), n a power of two;
// B blocks a set and ``units`` sets a block as ops/g1_vec.py::tree_plan
// chooses. ``scratch``: 36 sets B + sets words when B > 1 (the blocks'
// points, then the counters, which this call zeroes), else unused.
extern "C" int bpt_g1_tree(const void* x, const void* y, const void* z, long long limb_stride,
                           long long lane_stride, long long inner, long long outer_stride,
                           long long inner_stride, long long sets, long long n, long long B,
                           long long units, void* ox, void* oy, void* oz, void* scratch,
                           void* stream) {
  if (n < 1 || (n & (n - 1)) || B < 1 || (B & (B - 1)) || B > n || sets < 1 || inner < 1 ||
      units < 1 || (B > 1 && (units != 1 || scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long m = n / B, U = m > 1 ? m / 2 : 1;
  const long long threads = B == 1 ? units * U : (U > B / 2 ? U : B / 2);
  if (threads > TREE_THREADS) return (int)cudaErrorInvalidValue;
  TreeArgs a;
  a.x = (const int32_t*)x;
  a.y = (const int32_t*)y;
  a.z = (const int32_t*)z;
  a.limb_stride = limb_stride;
  a.lane_stride = lane_stride;
  a.inner = inner;
  a.outer_stride = outer_stride;
  a.inner_stride = inner_stride;
  a.sets = sets;
  a.n = n;
  a.ox = (int32_t*)ox;
  a.oy = (int32_t*)oy;
  a.oz = (int32_t*)oz;
  a.part = (uint32_t*)scratch;
  a.count = B > 1 ? (unsigned*)scratch + 36 * sets * B : nullptr;
  a.B = (int)B;
  a.units = (int)units;
  a.U = (int)U;
  if (B > 1) {
    cudaError_t rc = cudaMemsetAsync(a.count, 0, sets * sizeof(unsigned), (cudaStream_t)stream);
    if (rc != cudaSuccess) return (int)rc;
  }
  const long long blocks = B == 1 ? (sets + units - 1) / units : sets * B;
  g1_tree_kernel<<<(unsigned)blocks, (unsigned)threads, threads * 36 * sizeof(uint32_t),
                   (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
