// Fixed-base KZG commit MSM: the subset-sum tables (build and affine
// normalization), the windowed Horner loop over them, and the join of the
// windows.
//
// Replaces: msm_fixed_pallas + _fixed_indices + _msm_fixed_tile_kernel
// (baby_plonk_tpu/ops/pallas_kernels.py:185-293) and its XLA twin
// _msm_fixed_kernel_oh (ops/msm_fixed.py:197-228), the main path's commit
// MSM; and the table build _build_tables (ops/msm_fixed.py:82-131), which
// had no Pallas form. The per-lane partials are summed by the g1.cu
// addition launcher (ops/g1_vec.py::tree_reduce).
//
// Tables: for group g of 8 points P_{8g..8g+7}, entry idx holds
// sum_{j in idx} P_{8g+j}, affine. They are stored entry-major and packed,
// (G, 256, 24) 32-bit words: one entry is x (12 words) then y (12 words),
// 96 contiguous bytes, so a step reads 3 sectors of 32 bytes. (The JAX
// layout, two (24, G, 256) arrays of 16-bit limbs, would scatter one entry
// over 48 sectors; ops/msm_fixed.py::unpack_tables gives it back.) The
// identity (entry 0, or a subset that cancels) is the off-curve marker (0, 0).
//
// Bound of the Horner loop on this card: operations. A Horner step is a
// doubling and K mixed additions, 8 + 11 K Fq products on the integer
// multiply-add pipe (utils/roofline.py::horner_work), against 96 K bytes of
// table. Before the pipe, the length of one lane's dependent chain binds:
// 255 steps, whatever the number of lanes, until the card's lanes are
// filled.
//
// Design of the Horner loop: the 255 bits are cut into W windows of S =
// ceil(255 / W) bits, and a lane is (scalar set, window, slice), a slice
// being up to K groups of one chunk (the chunk's slots are its slices,
// rounded up to a power of two where K > 1; a slot past them stores the
// identity). A lane runs its window's steps, MSB first, acc = 2 acc +
// sum_k T[g_k][bits of group g_k's 8 scalars], with acc in registers (g1.cuh
// inlines the formulas): the doubling is shared by the K groups, since
// sum_g sum_b 2^b T_g[idx_g(b)] = sum_b 2^b sum_g T_g[idx_g(b)], and the
// additions are exact in any order (the mixed addition is complete in acc).
// The lanes of a (set, window) are summed by the addition tree, and
// bpt_msm_join runs the short Horner over the window sums, S doublings and
// an addition a window, one thread a set: that serial tail is the price of
// the W-fold shorter chains. W = 1 is the unsplit loop, K = 1 a lane a
// group. W > 1 where the lanes do not fill the card, K > 1 where they
// overfill it (ops/msm_fixed.py::windows_for, groups_per_lane). A lane skips
// index 0 and the (0, 0) marker (the mixed addition is not complete for an
// identity operand). Bit 255 of a canonical Fr scalar is 0.
//
// The table build (once per SRS) does the reference's work: 247 complete
// additions a group (one a subset of two or more points; the identity and
// the 8 single points are copies) and ONE field inversion a group
// (Montgomery's trick), where a Fermat inversion of every entry would cost
// 157,320 multiply-adds against 3,600 for the entry's addition. Bound
// (utils/roofline.py::tables_work): operations, the additions (0.89 M
// multiply-adds a group) before the trick's 5 products an entry (0.38 M)
// and the inversion (0.16 M); the bytes, 2,304 in and 24,576 out a group,
// take 1/11 of that time. The kernels do 1,568 products a group where the
// bound counts 1,280: a segment level of 32 products, and each lane's
// prefixes computed twice rather than kept (24 KB a group of scratch). Three launches, because a Fermat inversion
// is one serial chain of about 570 products (0.53 ms on this card) that
// only other groups' work can hide: fused into the build it would hold a
// warp and its shared memory for that long with one lane busy, so the
// inversions get a launch of their own, one thread a group, all in flight
// at once. The launches, all from bpt_msm_build_tables:
//   1. build_tables_kernel: one warp a group, 4 groups a block. The warp
//      builds the 16 subset sums of points 0-3 and of points 4-7 in shared
//      memory (the single points loaded, the rest in 3 levels of complete
//      additions, 11 a half), then entry idx = lo[idx & 15] + hi[idx >> 4]
//      for all 256 entries at once (a copy of the other half where one
//      index is 0: 225 additions), 8 a lane (lane l: entries l + 32 j, so
//      a store of the warp covers 32 consecutive entries). Two levels of
//      dependence, where the recurrence T[idx] = T[idx - 2^b] + P_b has 8
//      and needs all 256 projective entries (36 KB) in shared memory: at
//      4.6 KB a warp the block's shared memory never limits residency, the
//      registers do (255 a thread: 2 blocks of 4 warps an SM; capped at 168
//      for 3 blocks, the kernel spilled 264 bytes and took the same time,
//      3.00-3.02 against 3.02-3.04 ms over 8193 groups). The entry's
//      projective X, Y go to its packed slot, Z to a scratch, and each
//      lane multiplies up its 8 Z's into a segment product.
//   2. tables_invert_kernel: one thread a group: the 32 segment products'
//      prefix, one inversion, the back-sweep, giving each segment
//      product's inverse.
//   3. normalize_tables_kernel: one warp a group again; a lane recomputes
//      the prefix products of its 8 Z's into shared memory (12 KB a warp),
//      then sweeps back from its segment's inverse: 1/Z = (inverse of the
//      prefix through Z) (prefix before Z), and writes (X/Z, Y/Z) over the
//      slot. 5 products an entry.
// A zero Z (entry 0, the identity, in every group; a cancelling subset
// anywhere) multiplies into the products as one and comes out as (0, 0),
// as limbs.batch_inverse does (ops/limbs.py). The additions are the
// complete formulas (g1_add), so a repeated point, whose sum takes the
// doubling case, and a cancelling pair are both exact. The affine entries
// are unique, so the packed tables equal the plain version's (ops/
// msm_fixed.py::build_tables_plain) and the JAX package's word for word.
#include "g1.cuh"

using namespace bpt;

namespace {

constexpr int GROUP = 8;
constexpr int NB = 1 << GROUP;
constexpr int NBITS = 255;
constexpr int ENTRY = 24;   // 32-bit words of one packed entry
constexpr int GPB = 4;      // groups (warps) a block of the table kernels
constexpr int SEGS = 32;    // segments of a group: one a lane, 8 entries each
constexpr int PER_LANE = NB / SEGS;

// Point slots in shared memory, word-major: s[k][slot] for the 36 words of
// (X, Y, Z), so lanes that read distinct slots hit distinct banks.
__device__ __forceinline__ void smem_store(uint32_t (*s)[32], int slot, const G1P& p) {
#pragma unroll
  for (int k = 0; k < 12; k++) {
    s[k][slot] = p.x[k];
    s[12 + k][slot] = p.y[k];
    s[24 + k][slot] = p.z[k];
  }
}

__device__ __forceinline__ void smem_load(G1P& p, uint32_t (*s)[32], int slot) {
#pragma unroll
  for (int k = 0; k < 12; k++) {
    p.x[k] = s[k][slot];
    p.y[k] = s[12 + k][slot];
    p.z[k] = s[24 + k][slot];
  }
}

// Three uint4 moves of 12 words (16-byte aligned: every row here is a
// multiple of 48 bytes).
__device__ __forceinline__ void put12(uint32_t* dst, const uint32_t v[12]) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int k = 0; k < 3; k++) d[k] = make_uint4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

__device__ __forceinline__ void get12(uint32_t v[12], const uint32_t* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int k = 0; k < 3; k++) {
    const uint4 w = s[k];
    v[4 * k] = w.x, v[4 * k + 1] = w.y, v[4 * k + 2] = w.z, v[4 * k + 3] = w.w;
  }
}

// z, or one where z = 0 (the identity's Z counts as one in the products).
__device__ __forceinline__ void nonzero_or_one(uint32_t z[12]) {
  if (is_zero<Fq>(z)) set_one<Fq>(z);
}

// points: (24, 8G) x3 projective Montgomery. Out: packed (G, 256, 24) with
// every entry's projective (X, Y); zs (G, 256, 12) its Z; seg (G, 32, 12)
// the product of lane l's nonzero Z's (entries l + 32 j).
__global__ void __launch_bounds__(32 * GPB)
build_tables_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                    const int32_t* __restrict__ pz, int64_t G, uint32_t* __restrict__ packed,
                    uint32_t* __restrict__ zs, uint32_t* __restrict__ seg) {
  __shared__ uint32_t halves[GPB][36][32];  // slots 0-15: sums of points 0-3, 16-31: of 4-7
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t g = blockIdx.x * (int64_t)GPB + warp;
  if (g >= G) return;  // a whole warp: the kernel syncs warps only
  uint32_t(*h)[32] = halves[warp];
  const int t = lane & 15;  // the subset of the half's 4 points
  const int half = lane & 16;
  G1P p, q;
  if (t == 0) {
    g1_identity(p);
    smem_store(h, lane, p);
  } else if ((t & (t - 1)) == 0) {
    g1_load(p, px, py, pz, g * GROUP + (half >> 2) + (31 - __clz(t)), G * GROUP);
    smem_store(h, lane, p);
  }
  __syncwarp();
#pragma unroll 1
  for (int b = 1; b < 4; b++) {  // slots (2^b, 2^(b+1)) = slot t - 2^b + slot 2^b
    if (t > (1 << b) && t < (2 << b)) {
      smem_load(p, h, half | (t - (1 << b)));
      smem_load(q, h, half | (1 << b));
      g1_add(p, q);
      smem_store(h, lane, p);
    }
    __syncwarp();
  }
  uint32_t acc[12];
  set_one<Fq>(acc);
#pragma unroll 1
  for (int j = 0; j < PER_LANE; j++) {
    const int e = lane + SEGS * j, lo = e & 15, hi = e >> 4;
    if (lo == 0) {  // one half is the identity: a copy, not an addition
      smem_load(p, h, 16 | hi);
    } else {
      smem_load(p, h, lo);
      if (hi) {
        smem_load(q, h, 16 | hi);
        g1_add(p, q);
      }
    }
    const int64_t row = g * NB + e;
    put12(packed + row * ENTRY, p.x);
    put12(packed + row * ENTRY + 12, p.y);
    put12(zs + row * 12, p.z);
    nonzero_or_one(p.z);
    mul<Fq>(acc, acc, p.z);
  }
  put12(seg + (g * SEGS + lane) * 12, acc);
}

// seg (G, 32, 12) -> seginv (G, 32, 12): each segment product's inverse,
// by Montgomery's trick over the group's 32 with one Fermat inversion. One
// thread a group.
__global__ void tables_invert_kernel(const uint32_t* __restrict__ seg, int64_t G,
                                     uint32_t* __restrict__ seginv) {
  const int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (g >= G) return;
  const uint32_t* s = seg + g * SEGS * 12;
  uint32_t* out = seginv + g * SEGS * 12;
  uint32_t acc[12], v[12], inv[12];
  set_one<Fq>(acc);
#pragma unroll 1
  for (int i = 0; i < SEGS; i++) {  // out[i] = s[0] ... s[i - 1]
    put12(out + i * 12, acc);
    get12(v, s + i * 12);
    mul<Fq>(acc, acc, v);
  }
  inverse<Fq>(inv, acc);
#pragma unroll 1
  for (int i = SEGS - 1; i >= 0; i--) {  // inv = 1 / (s[0] ... s[i])
    get12(acc, out + i * 12);
    mul<Fq>(acc, inv, acc);
    put12(out + i * 12, acc);
    get12(v, s + i * 12);
    mul<Fq>(inv, inv, v);
  }
}

// packed (X, Y) -> (X / Z, Y / Z) in place, (0, 0) where Z = 0; zs and
// seginv as above. One warp a group.
__global__ void __launch_bounds__(32 * GPB)
normalize_tables_kernel(const uint32_t* __restrict__ zs, const uint32_t* __restrict__ seginv,
                        int64_t G, uint32_t* __restrict__ packed) {
  __shared__ uint32_t prefix[GPB][PER_LANE][12][32];  // lane's prefix before entry j, word-major
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t g = blockIdx.x * (int64_t)GPB + warp;
  if (g >= G) return;
  uint32_t acc[12], z[12], inv[12], zi[12];
  unsigned zero = 0;
  set_one<Fq>(acc);
#pragma unroll 1
  for (int j = 0; j < PER_LANE; j++) {
#pragma unroll
    for (int k = 0; k < 12; k++) prefix[warp][j][k][lane] = acc[k];
    get12(z, zs + (g * NB + lane + SEGS * j) * 12);
    zero |= (unsigned)is_zero<Fq>(z) << j;
    nonzero_or_one(z);
    if (j + 1 < PER_LANE) mul<Fq>(acc, acc, z);
  }
  get12(inv, seginv + (g * SEGS + lane) * 12);  // 1 / (all 8 of the lane's Z's)
#pragma unroll 1
  for (int j = PER_LANE - 1; j >= 0; j--) {
    const int64_t row = g * NB + lane + SEGS * j;
#pragma unroll
    for (int k = 0; k < 12; k++) acc[k] = prefix[warp][j][k][lane];
    mul<Fq>(zi, inv, acc);  // 1 / Z_j
    if (j > 0) {
      get12(z, zs + row * 12);
      nonzero_or_one(z);
      mul<Fq>(inv, inv, z);  // 1 / (Z's before j)
    }
    uint32_t x[12], y[12];
    get12(x, packed + row * ENTRY);
    get12(y, packed + row * ENTRY + 12);
    mul<Fq>(x, x, zi);
    mul<Fq>(y, y, zi);
    if ((zero >> j) & 1u) {
      set_zero<Fq>(x);
      set_zero<Fq>(y);
    }
    put12(packed + row * ENTRY, x);
    put12(packed + row * ENTRY + 12, y);
  }
}

// bits 4q .. 4q + 3 of each of 8 16-bit limbs -> word q of their step
// indices: byte i holds bit 4q + i of limb j at bit j. A nibble's 4 bits
// spread to the 4 bytes by one product (its shifted copies do not overlap).
__device__ __forceinline__ uint32_t step_indices(const uint32_t limb[GROUP], int q) {
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < GROUP; j++) word |= (((limb[j] >> (4 * q)) & 0xFu) * 0x204081u & 0x01010101u) << j;
  return word;
}

constexpr int HORNER_THREADS = 128;
constexpr int MAX_LANE_GROUPS = 16;

// The packed entry (x, y) of ``table`` at ``idx``: six 16-byte loads.
__device__ __forceinline__ void get_entry(uint32_t qx[12], uint32_t qy[12], const uint32_t* table, uint32_t idx) {
  const uint4* e = reinterpret_cast<const uint4*>(table + idx * ENTRY);
#pragma unroll
  for (int j = 0; j < 3; j++) {
    const uint4 vx = __ldg(e + j), vy = __ldg(e + 3 + j);
    qx[4 * j] = vx.x, qx[4 * j + 1] = vx.y, qx[4 * j + 2] = vx.z, qx[4 * j + 3] = vx.w;
    qy[4 * j] = vy.x, qy[4 * j + 1] = vy.y, qy[4 * j + 2] = vy.z, qy[4 * j + 3] = vy.w;
  }
}

// packed tables (Gt, 256, 24); scalars (16, P, 8G) raw limbs; out
// (24, P, W, L) x3, L = G / gc chunks of Lc slots and the rest's slots. A
// chunk of m groups (gc, or the rest's G mod gc) has M = ceil(m / K)
// slices: slice s holds its groups s, s + M, s + 2 M, ... (at most K), in
// slot c Lc + s of chunk c. Threads [0, P W R), R the slices of a (set,
// window), are the lanes, t = (p W + w) R + slice, each running bits
// [w S, min((w+1) S, 255)); the threads after them store the identity into
// the slots past the slices, so a wave holds no idle thread between lanes.
// The 32 lanes of a warp read 32 consecutive groups' tables at each of
// their K additions, as at K = 1, and load their scalars coalesced (slices
// of consecutive groups, a span K times wider, measured within 1% of it).
//
// SLICED = (K > 1). At K = 1 a lane holds its group's 8 scalar limbs in
// registers, cuts each step's index from them and loads the step's entry
// before the doubling, which hides the load: 167 registers, 3 blocks an SM.
// At K > 1 the step indices are staged in shared memory (16 bytes a group
// of the lane's slice, (K, 4, 128) words) and each group's entry is loaded
// after the doubling, just before its addition: 232 registers, 2 blocks an
// SM (ops/msm_fixed.py::SLICED_LANES_PER_SM), which add as fast as 3 at
// K = 1 do; held to 3 blocks, it spills and runs 10-20% slower.
template <bool SLICED>
__global__ void __launch_bounds__(HORNER_THREADS, SLICED ? 2 : 3)
msm_fixed_kernel(const uint32_t* __restrict__ packed, const int32_t* __restrict__ scalars,
                 int64_t P, int64_t G, int W, int S, int K, int64_t gc, int64_t Lc, int64_t L,
                 int32_t* ox, int32_t* oy, int32_t* oz) {
  extern __shared__ uint32_t step_words[];
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t lanes = P * W * L;
  if (t >= lanes) return;
  const int64_t full = G / gc, Rc = (gc + K - 1) / K, Rr = (G - full * gc + K - 1) / K;
  const int64_t R = full * Rc + Rr;
  G1P acc;
  g1_identity(acc);
  if (t >= P * W * R) {  // pad q of its (set, window): after the slices of a chunk, then of the rest
    const int64_t pad = t - P * W * R, per = L - R, q = pad % per, cp = Lc - Rc;
    const int64_t slot = q < full * cp ? q / cp * Lc + Rc + q % cp : full * Lc + Rr + (q - full * cp);
    g1_store(ox, oy, oz, pad / per * L + slot, lanes, acc);
    return;
  }
  const int64_t u = t / R, r = t % R;  // u = p W + w
  const int64_t c = r / Rc < full ? r / Rc : full, s = r - c * Rc;
  const int64_t m = c < full ? gc : G - full * gc, M = c < full ? Rc : Rr;
  const int n = (int)((m - s + M - 1) / M);
  const int64_t out = SLICED ? u * L + c * Lc + s : t;  // at K = 1 a slot is a group: t
  const int w = (int)(u % W);
  const int64_t sstride = P * G * GROUP;  // scalar limb stride
  const int32_t* sc = scalars + (u / W * G + c * gc + s) * GROUP;
  const uint32_t* table = packed + (c * gc + s) * (int64_t)(NB * ENTRY);
  const int lo = w * S;
  const int hi = min(lo + S, NBITS);
  uint32_t qx[12], qy[12];
  uint32_t limb[GROUP];
  uint32_t* words = step_words + threadIdx.x;  // word (k, q) at (4 k + q) HORNER_THREADS
  int held = -1;  // which 16-bit limb of the scalars the registers or shared words hold
#pragma unroll 1
  for (int bit = hi - 1; bit >= lo; bit--) {
    if ((bit >> 4) != held) {
      held = bit >> 4;
#pragma unroll 1
      for (int k = 0; k < (SLICED ? n : 1); k++) {
        const uint4* src = reinterpret_cast<const uint4*>(sc + held * sstride + k * M * GROUP);
        const uint4 s0 = __ldg(src), s1 = __ldg(src + 1);
        limb[0] = s0.x, limb[1] = s0.y, limb[2] = s0.z, limb[3] = s0.w;
        limb[4] = s1.x, limb[5] = s1.y, limb[6] = s1.z, limb[7] = s1.w;
        if (SLICED) {
#pragma unroll
          for (int q = 0; q < 4; q++) words[(4 * k + q) * HORNER_THREADS] = step_indices(limb, q);
        }
      }
    }
    if (!SLICED) {
      const int sh = bit & 15;
      uint32_t idx = 0;
#pragma unroll
      for (int j = 0; j < GROUP; j++) idx |= ((limb[j] >> sh) & 1u) << j;
      get_entry(qx, qy, table, idx);
      g1_double(acc);
      if (!(is_zero<Fq>(qx) && is_zero<Fq>(qy))) g1_add_mixed(acc, qx, qy);
      continue;
    }
    const int wq = (bit & 15) >> 2, sh = 8 * (bit & 3);
    g1_double(acc);
#pragma unroll 1
    for (int k = 0; k < n; k++) {
      const uint32_t idx = (words[(4 * k + wq) * HORNER_THREADS] >> sh) & 0xFFu;
      if (idx == 0) continue;
      get_entry(qx, qy, table + k * M * (NB * ENTRY), idx);
      if (!(is_zero<Fq>(qx) && is_zero<Fq>(qy))) g1_add_mixed(acc, qx, qy);
    }
  }
  g1_store(ox, oy, oz, out, lanes, acc);
}

// window sums (24, P, W) x3 -> (24, P) x3: sum_w 2^(w S) window_w, one
// thread a set, from the top window down.
__global__ void msm_join_kernel(const int32_t* __restrict__ wx, const int32_t* __restrict__ wy,
                                const int32_t* __restrict__ wz, int64_t P, int W, int S,
                                int32_t* ox, int32_t* oy, int32_t* oz) {
  const int64_t p = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (p >= P) return;
  G1P acc, q;
  g1_load(acc, wx, wy, wz, p * W + (W - 1), P * W);
#pragma unroll 1
  for (int w = W - 2; w >= 0; w--) {
#pragma unroll 1
    for (int s = 0; s < S; s++) g1_double(acc);
    g1_load(q, wx, wy, wz, p * W + w, P * W);
    g1_add(acc, q);
  }
  g1_store(ox, oy, oz, p, P, acc);
}

inline unsigned blocks_for(int64_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

// The three launches of the table build; zs (G, 256, 12), seg and seginv
// (G, 32, 12) are the caller's scratch.
extern "C" int bpt_msm_build_tables(const void* px, const void* py, const void* pz, long long G,
                                    void* packed, void* zs, void* seg, void* seginv, void* stream) {
  if (G < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = blocks_for(G, GPB);
  build_tables_kernel<<<blocks, 32 * GPB, 0, s>>>((const int32_t*)px, (const int32_t*)py,
                                                  (const int32_t*)pz, G, (uint32_t*)packed,
                                                  (uint32_t*)zs, (uint32_t*)seg);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  tables_invert_kernel<<<blocks_for(G, 128), 128, 0, s>>>((const uint32_t*)seg, G, (uint32_t*)seginv);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  normalize_tables_kernel<<<blocks, 32 * GPB, 0, s>>>((const uint32_t*)zs, (const uint32_t*)seginv, G,
                                                      (uint32_t*)packed);
  return (int)cudaGetLastError();
}

extern "C" int bpt_msm_fixed(const void* packed, const void* scalars, long long P, long long G,
                             int W, int S, int K, long long gc, long long Lc, long long L, void* ox,
                             void* oy, void* oz, void* stream) {
  if (W < 1 || S < 1 || (long long)W * S < NBITS || K < 1 || K > MAX_LANE_GROUPS || gc < 1 || Lc < 1 ||
      Lc * K < gc)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = blocks_for(P * W * L, HORNER_THREADS);
  const cudaStream_t s = (cudaStream_t)stream;
  if (K == 1)
    msm_fixed_kernel<false><<<blocks, HORNER_THREADS, 0, s>>>(
        (const uint32_t*)packed, (const int32_t*)scalars, P, G, W, S, K, gc, Lc, L, (int32_t*)ox,
        (int32_t*)oy, (int32_t*)oz);
  else
    msm_fixed_kernel<true><<<blocks, HORNER_THREADS, (size_t)K * 4 * HORNER_THREADS * sizeof(uint32_t), s>>>(
        (const uint32_t*)packed, (const int32_t*)scalars, P, G, W, S, K, gc, Lc, L, (int32_t*)ox,
        (int32_t*)oy, (int32_t*)oz);
  return (int)cudaGetLastError();
}

extern "C" int bpt_msm_join(const void* wx, const void* wy, const void* wz, long long P, int W,
                            int S, void* ox, void* oy, void* oz, void* stream) {
  if (W < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const int threads = 32;
  msm_join_kernel<<<blocks_for(P, threads), threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)wx, (const int32_t*)wy, (const int32_t*)wz, P, W, S, (int32_t*)ox,
      (int32_t*)oy, (int32_t*)oz);
  return (int)cudaGetLastError();
}
