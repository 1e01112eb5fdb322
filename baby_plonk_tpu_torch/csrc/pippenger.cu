// The variable-base Pippenger MSM's point work, one C entry point a call
// (bpt_msm_pippenger, a few launches): bucket sums, window totals and the
// Horner combine of sum_i s_i P_i over n projective points by 255-bit
// scalars in windows of c bits.
//
// Replaces: the point passes of msm_pippenger (baby_plonk_tpu/ops/
// msm_pippenger.py): the Hillis–Steele segmented sum over all n sorted
// points (_segmented_sum, :45-62), the suffix sums over the 2^c buckets
// (_bucket_suffix_total, :65-81) and the window shift of c one-lane
// doublings (:119-125), each level one full-width g1_vec.padd. A TPU cannot
// scatter points into buckets, so the JAX function turned the reference's
// bucket loop into scans of log2(n) full-width additions; on this card a
// thread walks a run of points, so the function does the reference's work:
// about n additions a window for the buckets, 2 a bucket for the totals,
// c doublings a window for the combine.
//
// Bound on this card. Operations: 12 Fq products an addition, 8 a doubling
// (utils/roofline.py::pippenger_work counts what this run's digits need),
// about 0.5 ms of multiply-adds at 65,538 points, c = 14. Bytes: each
// window's walk reads the points once (144 bytes a point); the packed copy
// of a 2^16-point MSM is 9.4 MB and stays in the 50 MB L2. Latency: the
// Horner combine is one chain of 252 doublings and 18 additions on one
// thread (about 2.2 ms at the one-lane doubling's 0.0087 ms): the latency
// floor of a variable-base MSM, which no layout removes; every other chain
// is kept short (below).
//
// Layout. The caller's points are (24, n) x3 limb-major; a walk reads them
// by sorted index, which in that layout touches 72 separate 32-byte
// sectors a point. So the first launch repacks them once into point-major
// (n, 36) 32-bit words (X, Y, Z of 12 words), and every later point read is
// 9 aligned 16-byte loads. Buckets, partials and totals use the same packed
// form. A thread holds two points and the formula's temporaries (about 248
// registers, as g1.cu's kernels), so a block is 128 threads, two an SM.
//
// 1. Bucket sums (walk_kernel). The caller sorts each window's digits
//    (stable, outside any kernel, as the JAX function leaves its argsort to
//    XLA). Each window's sorted order is cut into chunks of K points, one
//    thread a chunk; the thread adds each run of equal digits in order, so
//    no chain is longer than K - 1 additions (K is chosen to fill the card's
//    resident threads once: 37 at 65,538 points, c = 14). A run that closes
//    inside the chunk is its bucket's sum and is written to the bucket table
//    with a presence flag. A run that crosses the chunk's left edge leaves a
//    partial in the chunk's slot 0, one that crosses its right edge in slot
//    1 (a run that crosses both: slot 0, and slot 1 is marked as part of
//    the same run). Each slot carries a key, label << 1 | present. The next
//    level walks the 2 chunks slots of the level before in chunks of JOIN_K,
//    by the same rule (an absent slot continues its run and adds nothing;
//    the slots between two runs hold label 0, which never holds a point), so
//    the partials of a run that spans many chunks are joined in log depth: a
//    bucket that holds every point (all scalars equal) costs n / K partials
//    and about log(n / K) levels of at most JOIN_K - 1 additions, not an
//    n-long chain. The last level is one chunk a window. Digit 0 adds
//    nothing: its points are absent at the first level.
// 2. Window totals (segment_kernel): sum_{d >= 1} d B_d. The 2^c buckets of
//    a window are cut into segments of L, one thread a segment: from the top
//    bucket down R += B_d, and T += R at every bucket above the segment's
//    first, lo, which gives T = sum (d - lo) B_d in 2L - 1 dependent
//    additions (T waits in shared memory while R takes B_d). Then T += lo R,
//    lo R by double-and-add from lo's top bit (at most c doublings), so the
//    segments are independent. The block's 128 segments are summed by a
//    halving tree in shared memory, then (window_kernel) a window's blocks
//    by another. At the top window, where c = 14 leaves 3 bits, only the
//    first segment holds buckets; the others find nothing present and add
//    nothing.
// 3. Horner (horner_kernel): from the top window, c doublings (once the
//    total is present) and the window's total (where present) a window, one
//    thread.
// Every sum that may be empty carries a presence flag instead of the
// identity, so no addition of the identity is made. The order of additions
// is ops/msm_pippenger.py::msm_pippenger_plain's, limb for limb.
#include "g1.cuh"

using namespace bpt;

namespace {

constexpr int PW = 36;  // 32-bit words of a packed point
constexpr int THREADS = 128;
constexpr int BITS = 255;

__device__ __forceinline__ void pget(G1P& p, const uint32_t* src) {
  const uint4* v = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int k = 0; k < 3; k++) {
    const uint4 a = v[k], b = v[3 + k], c = v[6 + k];
    p.x[4 * k] = a.x, p.x[4 * k + 1] = a.y, p.x[4 * k + 2] = a.z, p.x[4 * k + 3] = a.w;
    p.y[4 * k] = b.x, p.y[4 * k + 1] = b.y, p.y[4 * k + 2] = b.z, p.y[4 * k + 3] = b.w;
    p.z[4 * k] = c.x, p.z[4 * k + 1] = c.y, p.z[4 * k + 2] = c.z, p.z[4 * k + 3] = c.w;
  }
}

__device__ __forceinline__ void pput(uint32_t* dst, const G1P& p) {
  uint4* v = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int k = 0; k < 3; k++) {
    v[k] = make_uint4(p.x[4 * k], p.x[4 * k + 1], p.x[4 * k + 2], p.x[4 * k + 3]);
    v[3 + k] = make_uint4(p.y[4 * k], p.y[4 * k + 1], p.y[4 * k + 2], p.y[4 * k + 3]);
    v[6 + k] = make_uint4(p.z[4 * k], p.z[4 * k + 1], p.z[4 * k + 2], p.z[4 * k + 3]);
  }
}

// acc (present: have) += q, q present: an addition, or a copy into an empty acc.
__device__ __forceinline__ void comb(G1P& acc, bool& have, const G1P& q) {
  if (have) {
    g1_add(acc, q);
  } else {
    acc = q;
    have = true;
  }
}

__global__ void __launch_bounds__(THREADS)
repack_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y, const int32_t* __restrict__ z,
              int64_t n, uint32_t* out) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  G1P p;
  g1_load(p, x, y, z, i, n);
  pput(out + i * PW, p);
}

// One walk level over nwin windows of m elements, chunks of K.
struct Walk {
  int64_t m, K, chunks;
  int nwin, nb;
  const int32_t* keys;   // (nwin, m): first level the sorted digits, else label << 1 | present
  const int32_t* order;  // first level: (nwin, m) the points' indices in sorted order
  const uint32_t* pts;   // first level: the packed points (n, 36); else (nwin, m, 36)
  int32_t* keys_out;     // (nwin, 2 chunks), null at the last level (one chunk a window)
  uint32_t* pts_out;     // (nwin, 2 chunks, 36)
  uint32_t* buckets;     // (nwin, nb, 36)
  int32_t* present;      // (nwin, nb)
};

template <bool FIRST>
__device__ __forceinline__ int key_at(const Walk& a, int64_t w, int64_t p) {
  const int k = __ldg(a.keys + w * a.m + p);
  return FIRST ? (k << 1) | (k != 0) : k;
}

template <bool FIRST>
__global__ void __launch_bounds__(THREADS) walk_kernel(Walk a) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= a.nwin * a.chunks) return;
  const int64_t w = t / a.chunks, j = t % a.chunks;
  const int64_t lo = j * a.K, hi = lo + a.K < a.m ? lo + a.K : a.m;
  int cur = key_at<FIRST>(a, w, lo) >> 1;
  const bool cl0 = lo > 0 && (key_at<FIRST>(a, w, lo - 1) >> 1) == cur;
  const int nxt = hi < a.m ? key_at<FIRST>(a, w, hi) >> 1 : -1;
  bool first = true, have = false;
  int key0 = 0, key1 = 0;
  G1P acc, q;
  g1_identity(acc);
#pragma unroll 1
  for (int64_t p = lo;; p++) {
    const bool end = p == hi;
    const int k = end ? 0 : key_at<FIRST>(a, w, p);
    if (end || (p > lo && (k >> 1) != cur)) {  // the run `cur` closes in this chunk
      const bool cl = first && cl0, cr = end && nxt == cur;
      if (!cl && !cr) {
        if (have) {
          pput(a.buckets + (w * a.nb + cur) * PW, acc);
          a.present[w * a.nb + cur] = 1;
        }
      } else {
        const int run_key = (cur << 1) | (int)have;
        if (have) pput(a.pts_out + (w * 2 * a.chunks + 2 * j + (cl ? 0 : 1)) * PW, acc);
        if (cl) {
          key0 = run_key;
          if (cr) key1 = cur << 1;
        } else {
          key1 = run_key;
        }
      }
      if (end) break;
      cur = k >> 1;
      first = false;
      have = false;
    }
    if (k & 1) {
      pget(q, a.pts + (FIRST ? (int64_t)__ldg(a.order + w * a.m + p) : w * a.m + p) * PW);
      comb(acc, have, q);
    }
  }
  if (a.keys_out) {
    a.keys_out[w * 2 * a.chunks + 2 * j] = key0;
    a.keys_out[w * 2 * a.chunks + 2 * j + 1] = key1;
  }
}

// Halving tree with presence over the block's slots in shared memory (sm:
// 36 words a thread, word-major; flag: one a thread): level h adds slot
// tid + h into slot tid, tid < h; slot 0 and flag[0] end with the sum.
// Every thread of the block calls it; it starts and ends with a barrier.
__device__ __forceinline__ void present_tree(uint32_t* sm, int* flag, G1P& u, G1P& v) {
  const int tid = threadIdx.x, slots = blockDim.x;
#pragma unroll 1
  for (int h = slots >> 1; h >= 1; h >>= 1) {
    __syncthreads();
    if (tid < h && flag[tid + h]) {
      g1_smem_get(v, sm, slots, tid + h);
      if (flag[tid]) {
        g1_smem_get(u, sm, slots, tid);
        g1_add(u, v);
        g1_smem_put(sm, slots, tid, u);
      } else {
        g1_smem_put(sm, slots, tid, v);
        flag[tid] = 1;
      }
    }
  }
  __syncthreads();
}

struct Seg {
  const uint32_t* buckets;  // (nwin, nb, 36)
  const int32_t* present;   // (nwin, nb)
  int64_t nseg;             // segments a window
  int nb, L, c;
  uint32_t* parts;          // (nwin, nseg / blockDim, 36)
  int32_t* part_flags;      // (nwin, nseg / blockDim)
};

__global__ void __launch_bounds__(THREADS) segment_kernel(Seg a) {
  extern __shared__ uint32_t sm[];
  const int tid = threadIdx.x, bs = blockDim.x;
  int* flag = reinterpret_cast<int*>(sm + PW * bs);
  const int64_t t = blockIdx.x * (int64_t)bs + tid;
  const int64_t w = t / a.nseg, s = t % a.nseg;
  const int lo = (int)(s * a.L);
  const int32_t* pres = a.present + w * a.nb;
  const uint32_t* bk = a.buckets + w * a.nb * PW;
  G1P r, b;
  bool hr = false, ht = false;
#pragma unroll 1
  for (int d = lo + a.L - 1; d >= lo; d--) {
    if (pres[d]) {
      pget(b, bk + (int64_t)d * PW);
      comb(r, hr, b);
    }
    if (d > lo && hr) {  // T += R, T kept in this thread's slot
      if (ht) {
        g1_smem_get(b, sm, bs, tid);
        g1_add(b, r);
      } else {
        b = r;
        ht = true;
      }
      g1_smem_put(sm, bs, tid, b);
    }
  }
  if (hr && lo > 0) {  // T += lo R, lo R by double-and-add from the top bit
    bool hs = false;
#pragma unroll 1
    for (int bit = a.c - 1; bit >= 0; bit--) {
      if (hs) g1_double(b);
      if ((lo >> bit) & 1) comb(b, hs, r);
    }
    if (ht) {
      g1_smem_get(r, sm, bs, tid);
      g1_add(b, r);
    }
    g1_smem_put(sm, bs, tid, b);
    ht = true;
  }
  flag[tid] = ht;
  present_tree(sm, flag, r, b);
  if (tid == 0) {
    const int64_t part = blockIdx.x;  // = w nseg / bs + s / bs
    a.part_flags[part] = flag[0];
    if (flag[0]) {
      g1_smem_get(r, sm, bs, 0);
      pput(a.parts + part * PW, r);
    }
  }
}

// One block a window, one thread a part: the window's parts by a halving tree.
__global__ void __launch_bounds__(THREADS)
window_kernel(const uint32_t* parts, const int32_t* part_flags, uint32_t* wtot, int32_t* wflag) {
  extern __shared__ uint32_t sm[];
  const int tid = threadIdx.x, np = blockDim.x;
  int* flag = reinterpret_cast<int*>(sm + PW * np);
  const int64_t part = (int64_t)blockIdx.x * np + tid;
  G1P u, v;
  flag[tid] = part_flags[part];
  if (flag[tid]) {
    pget(u, parts + part * PW);
    g1_smem_put(sm, np, tid, u);
  }
  present_tree(sm, flag, u, v);
  if (tid == 0) {
    wflag[blockIdx.x] = flag[0];
    if (flag[0]) {
      g1_smem_get(u, sm, np, 0);
      pput(wtot + (int64_t)blockIdx.x * PW, u);
    }
  }
}

__global__ void horner_kernel(const uint32_t* wtot, const int32_t* wflag, int nwin, int c, int32_t* ox,
                              int32_t* oy, int32_t* oz) {
  G1P tot, q;
  bool have = false;
  g1_identity(tot);
#pragma unroll 1
  for (int w = nwin - 1; w >= 0; w--) {
    if (have) {
#pragma unroll 1
      for (int i = 0; i < c; i++) g1_double(tot);
    }
    if (wflag[w]) {
      pget(q, wtot + (int64_t)w * PW);
      comb(tot, have, q);
    }
  }
  if (!have) g1_identity(tot);
  g1_store(ox, oy, oz, 0, 1, tot);
}

// Scratch of one call, in 32-bit words; every point array starts on a
// 16-byte boundary.
struct Layout {
  int64_t packed, buckets, present, level_pts[2], level_keys[2], parts, part_flags, wtot, wflag, total;
};

int64_t up4(int64_t x) { return (x + 3) & ~int64_t(3); }

// false when the plan is not one the kernels take (ops/msm_pippenger.py::
// _check_plan states the same rules).
bool layout(int64_t n, int c, int64_t K0, int64_t K1, int64_t L, int64_t bs, Layout& o) {
  if (n < 1 || c < 1 || c > 16 || K0 < 4 || K1 < 4) return false;
  const int64_t nb = int64_t(1) << c, nwin = (BITS + c - 1) / c;
  if (L < 1 || (L & (L - 1)) || L > nb) return false;
  const int64_t nseg = nb / L;
  if (bs < 1 || (bs & (bs - 1)) || bs > THREADS || nseg % bs || nseg / bs > THREADS) return false;
  const int64_t m1 = n > K0 ? 2 * ((n + K0 - 1) / K0) : 0;  // the largest later level
  int64_t off = 0;
  o.packed = off, off = up4(off + n * PW);
  o.buckets = off, off = up4(off + nwin * nb * PW);
  o.present = off, off = up4(off + nwin * nb);
  for (int i = 0; i < 2; i++) {
    o.level_pts[i] = off, off = up4(off + nwin * m1 * PW);
    o.level_keys[i] = off, off = up4(off + nwin * m1);
  }
  const int64_t parts = nwin * (nseg / bs);
  o.parts = off, off = up4(off + parts * PW);
  o.part_flags = off, off = up4(off + parts);
  o.wtot = off, off = up4(off + nwin * PW);
  o.wflag = off, off = up4(off + nwin);
  o.total = off;
  return true;
}

template <bool FIRST>
cudaError_t launch_walk(const Walk& a, cudaStream_t s) {
  const int64_t threads = a.nwin * a.chunks;
  walk_kernel<FIRST><<<(unsigned)((threads + THREADS - 1) / THREADS), THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Scratch words of one bpt_msm_pippenger call, or -1 for a plan it refuses.
extern "C" long long bpt_msm_pippenger_scratch(long long n, int c, long long K0, long long K1, long long L,
                                              long long bs) {
  Layout o;
  return layout(n, c, K0, K1, L, bs, o) ? o.total : -1;
}

// sum_i s_i P_i of (24, n) x3 projective Montgomery points, each window's
// c-bit digits sorted: ``digits`` (nwin, n) ascending, ``order`` (nwin, n)
// the points' indices in that order (int32). Plan: chunks of K0 points,
// later levels of K1 partials, segments of L buckets, bs segments a block.
// Writes the sum to (ox, oy, oz), (24,) each.
extern "C" int bpt_msm_pippenger(const void* x, const void* y, const void* z, long long n, const void* digits,
                                 const void* order, int c, long long K0, long long K1, long long L, long long bs,
                                 void* scratch, long long scratch_words, void* ox, void* oy, void* oz,
                                 void* stream) {
  Layout o;
  if (!layout(n, c, K0, K1, L, bs, o) || scratch_words < o.total) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* base = (uint32_t*)scratch;
  const int nwin = (BITS + c - 1) / c, nb = 1 << c;
  const int64_t nseg = nb / L;
  int32_t* present = (int32_t*)(base + o.present);
  cudaError_t rc = cudaMemsetAsync(present, 0, (size_t)nwin * nb * sizeof(int32_t), s);
  if (rc != cudaSuccess) return (int)rc;

  repack_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, n, base + o.packed);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;

  // the walk levels: the sorted points, then the partial slots until one
  // chunk a window remains (ops/msm_pippenger.py::levels)
  Walk a;
  a.nwin = nwin, a.nb = nb;
  a.buckets = base + o.buckets, a.present = present;
  a.m = n, a.K = K0;
  a.keys = (const int32_t*)digits, a.order = (const int32_t*)order, a.pts = base + o.packed;
  for (int level = 0;; level++) {
    a.chunks = (a.m + a.K - 1) / a.K;
    const bool last = a.chunks == 1;
    const int out = level & 1;
    a.keys_out = last ? nullptr : (int32_t*)(base + o.level_keys[out]);
    a.pts_out = base + o.level_pts[out];
    rc = level == 0 ? launch_walk<true>(a, s) : launch_walk<false>(a, s);
    if (rc != cudaSuccess) return (int)rc;
    if (last) break;
    a.m = 2 * a.chunks, a.K = K1;
    a.keys = a.keys_out, a.order = nullptr, a.pts = a.pts_out;
  }

  Seg g;
  g.buckets = base + o.buckets, g.present = present;
  g.nseg = nseg, g.nb = nb, g.L = (int)L, g.c = c;
  g.parts = base + o.parts, g.part_flags = (int32_t*)(base + o.part_flags);
  const size_t smem = (size_t)bs * (PW + 1) * sizeof(uint32_t);
  segment_kernel<<<(unsigned)(nwin * nseg / bs), (unsigned)bs, smem, s>>>(g);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;

  const int np = (int)(nseg / bs);
  window_kernel<<<nwin, np, (size_t)np * (PW + 1) * sizeof(uint32_t), s>>>(
      base + o.parts, (const int32_t*)(base + o.part_flags), base + o.wtot, (int32_t*)(base + o.wflag));
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;

  horner_kernel<<<1, 1, 0, s>>>(base + o.wtot, (const int32_t*)(base + o.wflag), nwin, c, (int32_t*)ox,
                                (int32_t*)oy, (int32_t*)oz);
  return (int)cudaGetLastError();
}
