// Fr / Fq field kernels: the elementwise operations (Montgomery multiply and
// square, add, sub, neg, to/from Montgomery form, lane select), and what the
// reference compiled into one executable around them: the power, the prefix
// scans, the power table and the fused expressions of rounds 2 and 3.
//
// Replaces: mont_mul_pallas (baby_plonk_tpu/ops/pallas_kernels.py:43, a tiled
// elementwise Montgomery product) and the XLA elementwise ops it stood beside
// (ops/limbs.py: add_mod/sub_mod/neg_mod :325-345, to_mont/from_mont
// :812-824, select :829, mont_pow_fixed :842, doubling_scan :860), with
// _round3_combine_rows (ops/prover_kernels.py:75) and the f and g of
// _grand_product_full (ops/tpu_engine.py:85). jax.jit fused those into single
// executables; run eagerly they are a launch a field operation, most of
// them on one lane or as log2 n full-width passes, so on this card the cost
// was the number of launches and of passes over memory, not the arithmetic.
//
// Bound on this card: device-memory bandwidth for add/sub, the scans and the
// fused expressions (a 16-limb int32 element is 64 bytes each way), the
// integer multiply-add pipe for the Montgomery product (64 32x32->64 products
// for Fr, 144 for Fq, plus as many for the reduction, per element) and the
// power (a chain of dependent products). Each kernel's note says what its
// design does about its bound.
//
// Elementwise design: one thread per element in a grid-stride loop; each
// thread repacks its element's 16-bit limbs into 32-bit words in registers,
// runs the carry chains of field.cuh, and writes the limbs back. Limb-major
// layout makes every limb load coalesced across a warp. Broadcasting is an
// index map: output element i reads operand element (i / div) % mod; where no
// operand is broadcast a second instantiation drops the map and its 64-bit
// divisions.
#include "field.cuh"

using namespace bpt;

namespace {

enum Op { MUL = 0, ADD = 1, SUB = 2, NEG = 3, TO_MONT = 4, FROM_MONT = 5, SQR = 6 };

// FLAT: no operand is broadcast (both have the output's n elements), so the
// index map and its 64-bit divisions drop out.
template <class F, bool FLAT>
__global__ void field_op_kernel(int op, const int32_t* __restrict__ a, int64_t a_div, int64_t a_mod,
                                const int32_t* __restrict__ b, int64_t b_div, int64_t b_mod,
                                int32_t* __restrict__ out, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t ia = FLAT ? i : (i / a_div) % a_mod, sa = FLAT ? n : a_mod;
    const int64_t ib = FLAT ? i : (i / b_div) % b_mod, sb = FLAT ? n : b_mod;
    uint32_t x[F::N], y[F::N], r[F::N];
    load<F>(x, a + ia, sa);
    switch (op) {
      case MUL:
        load<F>(y, b + ib, sb);
        mul<F>(r, x, y);
        break;
      case ADD:
        load<F>(y, b + ib, sb);
        add<F>(r, x, y);
        break;
      case SUB:
        load<F>(y, b + ib, sb);
        sub<F>(r, x, y);
        break;
      case NEG:
        neg<F>(r, x);
        break;
      case TO_MONT:
#pragma unroll
        for (int k = 0; k < F::N; k++) y[k] = F::r2(k);
        mul<F>(r, x, y);
        break;
      case FROM_MONT:
#pragma unroll
        for (int k = 0; k < F::N; k++) y[k] = k == 0 ? 1u : 0u;
        mul<F>(r, x, y);
        break;
      default:  // SQR
        sqr<F>(r, x);
        break;
    }
    store<F>(out + i, n, r);
  }
}

__global__ void select_kernel(int L, const bool* __restrict__ cond, int64_t c_div, int64_t c_mod,
                              const int32_t* __restrict__ a, int64_t a_div, int64_t a_mod,
                              const int32_t* __restrict__ b, int64_t b_div, int64_t b_mod,
                              int32_t* __restrict__ out, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const bool c = cond[(i / c_div) % c_mod];
    const int32_t* src = c ? a + (i / a_div) % a_mod : b + (i / b_div) % b_mod;
    const int64_t stride = c ? a_mod : b_mod;
    for (int k = 0; k < L; k++) out[k * n + i] = src[k * stride];
  }
}

inline int grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  return (int)(blocks < 65536 ? blocks : 65536);
}

// -- power ---------------------------------------------------------------------
// a^e per lane for one exponent shared by all lanes: left-to-right
// square-and-multiply inside one thread, the running value in registers.
// Bound: operations (one square per bit below the top, one product per set
// bit; 128 bytes a lane). On one lane it is pure latency, a chain of dependent
// products, but one launch where the eager composition made one a product.

struct Exponent {
  uint32_t w[12];
  int top;  // index of the highest set bit
};

template <class F>
__global__ void field_pow_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                                 int64_t n, Exponent e) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    uint32_t x[F::N], r[F::N];
    load<F>(x, a + i, n);
    copy<F>(r, x);
#pragma unroll 1
    for (int bit = e.top - 1; bit >= 0; bit--) {
      sqr<F>(r, r);
      if ((e.w[bit >> 5] >> (bit & 31)) & 1u) mul<F>(r, r, x);
    }
    store<F>(out + i, n, r);
  }
}

// -- scans ---------------------------------------------------------------------
// Inclusive or exclusive prefix product / prefix sum along the last axis of
// (L, rows, n), forward or reversed, in n work: reduce-then-scan over tiles of
// SCAN_THREADS elements. Launch 1 reduces every tile to its total, launch 2
// scans the totals of a row (one block a row, a carry across its tiles),
// launch 3 scans every tile again and combines it with its tile's prefix. A
// row of one tile is launch 3 alone. Inside a tile: one element a thread, a
// shuffle scan in each warp, warp 0 scans the warp totals through shared
// memory. Bound: bytes for the sum (x read, out written), operations for the
// product (one product an element at the least; this design spends about 7:
// 5 shuffle steps, the warp prefix and the tile prefix).
//
// "Reversed" scans logical index j = n - 1 - physical index; "exclusive"
// stores the inclusive value of j at j + 1 and the identity at 0. Both are
// index maps here, where the composition flipped and concatenated tensors.

enum ScanOp { SCAN_MUL = 0, SCAN_ADD = 1 };
constexpr int SCAN_THREADS = 256;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;

template <class F, int OP>
__device__ __forceinline__ void combine(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  if (OP == SCAN_MUL)
    mul<F>(r, a, b);
  else
    add<F>(r, a, b);
}

template <class F, int OP>
__device__ __forceinline__ void set_identity(uint32_t* r) {
  if (OP == SCAN_MUL)
    set_one<F>(r);
  else
    set_zero<F>(r);
}

// Inclusive scan of the block's SCAN_THREADS values x (one a thread, thread
// order); total = the combination of all of them. sh holds SCAN_WARPS elements.
template <class F, int OP>
__device__ __forceinline__ void block_scan(uint32_t x[F::N], uint32_t* sh, uint32_t total[F::N]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t y[F::N];
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int k = 0; k < F::N; k++) y[k] = __shfl_up_sync(0xffffffffu, x[k], d);
    if (lane >= d) combine<F, OP>(x, y, x);
  }
  if (lane == 31) {
#pragma unroll
    for (int k = 0; k < F::N; k++) sh[warp * F::N + k] = x[k];
  }
  __syncthreads();
  if (warp == 0) {
    uint32_t t[F::N];
    if (lane < SCAN_WARPS) {
#pragma unroll
      for (int k = 0; k < F::N; k++) t[k] = sh[lane * F::N + k];
    } else {
      set_identity<F, OP>(t);
    }
#pragma unroll 1
    for (int d = 1; d < SCAN_WARPS; d <<= 1) {
#pragma unroll
      for (int k = 0; k < F::N; k++) y[k] = __shfl_up_sync(0xffffffffu, t[k], d);
      if (lane >= d) combine<F, OP>(t, y, t);
    }
    if (lane < SCAN_WARPS) {
#pragma unroll
      for (int k = 0; k < F::N; k++) sh[lane * F::N + k] = t[k];
    }
  }
  __syncthreads();
  if (warp > 0) {
#pragma unroll
    for (int k = 0; k < F::N; k++) y[k] = sh[(warp - 1) * F::N + k];
    combine<F, OP>(x, y, x);
  }
#pragma unroll
  for (int k = 0; k < F::N; k++) total[k] = sh[(SCAN_WARPS - 1) * F::N + k];
}

// Logical element j of row ``row`` into v (the identity past the end).
template <class F, int OP>
__device__ __forceinline__ void scan_load(uint32_t v[F::N], const int32_t* x, int64_t rows,
                                          int64_t n, int64_t row, int64_t j, int reverse) {
  if (j < n)
    load<F>(v, x + row * n + (reverse ? n - 1 - j : j), rows * n);
  else
    set_identity<F, OP>(v);
}

// Launch 1: totals (L, rows, tiles).
template <class F, int OP>
__global__ void scan_totals_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ totals,
                                   int64_t rows, int64_t n, int64_t tiles, int reverse) {
  __shared__ uint32_t sh[SCAN_WARPS * F::N];
  const int64_t row = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  uint32_t v[F::N], total[F::N];
  scan_load<F, OP>(v, x, rows, n, row, tile * SCAN_THREADS + threadIdx.x, reverse);
  block_scan<F, OP>(v, sh, total);
  if (threadIdx.x == 0) store<F>(totals + row * tiles + tile, rows * tiles, total);
}

// Launch 2: prefix[row][t] = totals[row][0] .. totals[row][t - 1] combined
// (the identity at t = 0); one block a row.
template <class F, int OP>
__global__ void scan_prefix_kernel(const int32_t* __restrict__ totals, int32_t* __restrict__ prefix,
                                   int64_t rows, int64_t tiles) {
  __shared__ uint32_t sh[SCAN_WARPS * F::N];
  const int64_t row = blockIdx.x;
  uint32_t carry[F::N], v[F::N], total[F::N];
  set_identity<F, OP>(carry);
  if (threadIdx.x == 0) store<F>(prefix + row * tiles, rows * tiles, carry);
  for (int64_t base = 0; base < tiles; base += SCAN_THREADS) {
    const int64_t t = base + threadIdx.x;
    scan_load<F, OP>(v, totals, rows, tiles, row, t, 0);
    block_scan<F, OP>(v, sh, total);
    combine<F, OP>(v, carry, v);
    if (t + 1 < tiles) store<F>(prefix + row * tiles + t + 1, rows * tiles, v);
    combine<F, OP>(carry, carry, total);
    __syncthreads();  // sh is written again by the next tile
  }
}

// Launch 3: the scan itself. prefix may be null (one tile a row); total, if
// not null, receives each row's combination of all n elements as (L, rows).
template <class F, int OP>
__global__ void scan_apply_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ prefix,
                                  int32_t* __restrict__ out, int32_t* __restrict__ total_out,
                                  int64_t rows, int64_t n, int64_t tiles, int reverse,
                                  int exclusive) {
  __shared__ uint32_t sh[SCAN_WARPS * F::N];
  const int64_t row = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int64_t j = tile * SCAN_THREADS + threadIdx.x;
  uint32_t v[F::N], total[F::N];
  scan_load<F, OP>(v, x, rows, n, row, j, reverse);
  block_scan<F, OP>(v, sh, total);
  if (prefix != nullptr) {
    uint32_t p[F::N];
    load<F>(p, prefix + row * tiles + tile, rows * tiles);
    combine<F, OP>(v, p, v);
  }
  if (j >= n) return;
  if (total_out != nullptr && j == n - 1) store<F>(total_out + row, rows, v);
  int64_t dst = j;
  if (exclusive) {
    if (j == 0) {
      uint32_t id[F::N];
      set_identity<F, OP>(id);
      store<F>(out + row * n + (reverse ? n - 1 : 0), rows * n, id);
    }
    dst = j + 1;
    if (dst >= n) return;
  }
  store<F>(out + row * n + (reverse ? n - 1 - dst : dst), rows * n, v);
}

template <class F, int OP>
int scan_launch(const int32_t* x, int32_t* out, int32_t* total, int32_t* totals, int32_t* prefix,
                int64_t rows, int64_t n, int reverse, int exclusive, cudaStream_t s) {
  const int64_t tiles = (n + SCAN_THREADS - 1) / SCAN_THREADS;
  const unsigned grid = (unsigned)(rows * tiles);
  if (tiles > 1) {
    scan_totals_kernel<F, OP><<<grid, SCAN_THREADS, 0, s>>>(x, totals, rows, n, tiles, reverse);
    scan_prefix_kernel<F, OP><<<(unsigned)rows, SCAN_THREADS, 0, s>>>(totals, prefix, rows, tiles);
  }
  scan_apply_kernel<F, OP><<<grid, SCAN_THREADS, 0, s>>>(
      x, tiles > 1 ? prefix : nullptr, out, total, rows, n, tiles, reverse, exclusive);
  return (int)cudaGetLastError();
}

// -- power table -----------------------------------------------------------------
// out[i] = z^i, i < n, for one Montgomery z: a kernel of its own, not the scan
// of a broadcast operand (that would read n copies of z). A thread raises z to
// its first index by square-and-multiply and then walks POW_RUN indices a
// block width apart, multiplying by z^blockDim each step, so that a warp's
// stores stay contiguous. Bound: bytes (n elements written); about
// (2 log2 n + 8 + POW_RUN) / POW_RUN products an element.

constexpr int POW_THREADS = 128;  // a power of two
constexpr int POW_RUN = 8;

template <class F>
__global__ void pow_table_kernel(const int32_t* __restrict__ z, int32_t* __restrict__ out,
                                 int64_t n) {
  const int64_t first = blockIdx.x * (int64_t)(POW_THREADS * POW_RUN) + threadIdx.x;
  if (first >= n) return;
  uint32_t zz[F::N], step[F::N], r[F::N];
  load<F>(zz, z, 1);
  copy<F>(step, zz);
#pragma unroll 1
  for (int s = 1; s < POW_THREADS; s <<= 1) sqr<F>(step, step);
  set_one<F>(r);
  if (first > 0) {
#pragma unroll 1
    for (int bit = 63 - __clzll((long long)first); bit >= 0; bit--) {
      sqr<F>(r, r);
      if ((first >> bit) & 1) mul<F>(r, r, zz);
    }
  }
#pragma unroll 1
  for (int k = 0; k < POW_RUN; k++) {
    const int64_t i = first + (int64_t)k * POW_THREADS;
    if (i >= n) return;
    store<F>(out + i, n, r);
    mul<F>(r, r, step);
  }
}

// -- fused round expressions (Fr) ----------------------------------------------
// What jax.jit fused in the reference: every intermediate stays in registers,
// each row is read once and the result written once. Bound: bytes.

// x + beta y + gamma
__device__ __forceinline__ void rlc(uint32_t r[8], const uint32_t x[8], const uint32_t y[8],
                                    const uint32_t beta[8], const uint32_t gamma[8]) {
  uint32_t t[8];
  mul<Fr>(t, beta, y);
  add<Fr>(t, t, x);
  add<Fr>(r, t, gamma);
}

// Round 2 (tpu_engine.py::_grand_product_full, the two products before the
// scans): f = rlc(a, w) rlc(b, k1 w) rlc(c, k2 w), g = rlc(a, s1) rlc(b, s2)
// rlc(c, s3); 7 rows of (16, n) in, 2 out. sc: (16, 4) = beta, gamma, k1, k2.
__global__ void grand_product_fg_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                                        const int32_t* __restrict__ c, const int32_t* __restrict__ s1,
                                        const int32_t* __restrict__ s2, const int32_t* __restrict__ s3,
                                        const int32_t* __restrict__ roots, const int32_t* __restrict__ sc,
                                        int32_t* __restrict__ f, int32_t* __restrict__ g, int64_t n) {
  uint32_t beta[8], gamma[8], k[8];
  load<Fr>(beta, sc + 0, 4);
  load<Fr>(gamma, sc + 1, 4);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    uint32_t x[8], w[8], y[8], t[8], acc[8];
    load<Fr>(w, roots + i, n);
    load<Fr>(x, a + i, n);
    rlc(acc, x, w, beta, gamma);
    load<Fr>(y, s1 + i, n);
    uint32_t gacc[8];
    rlc(gacc, x, y, beta, gamma);
    load<Fr>(x, b + i, n);
    load<Fr>(k, sc + 2, 4);
    mul<Fr>(y, k, w);
    rlc(t, x, y, beta, gamma);
    mul<Fr>(acc, acc, t);
    load<Fr>(y, s2 + i, n);
    rlc(t, x, y, beta, gamma);
    mul<Fr>(gacc, gacc, t);
    load<Fr>(x, c + i, n);
    load<Fr>(k, sc + 3, 4);
    mul<Fr>(y, k, w);
    rlc(t, x, y, beta, gamma);
    mul<Fr>(acc, acc, t);
    load<Fr>(y, s3 + i, n);
    rlc(t, x, y, beta, gamma);
    mul<Fr>(gacc, gacc, t);
    store<Fr>(f + i, n, acc);
    store<Fr>(g + i, n, gacc);
  }
}

// Round 3 (prover_kernels.py::_round3_combine_rows): gate + alpha perm +
// alpha^2 first-row, times 1/Z_H, per lane of the 4n coset domain.
// live: (16, 5, m) rows a b c z pi; fixed: (16, 9, m) rows s1 s2 s3 ql qr qm
// qo qc l1; zh_inv, dpow: (16, m); sc: (16, 6) = beta, gamma, alpha, alpha^2,
// k1, k2; z(w x) is read ``shift`` lanes ahead (mod m) in zw (limb stride
// zw_stride): live's z row on one device, another shard's z row on a mesh.
// 16 rows in (17 with a zw row of its own), 1 out.
__global__ void round3_combine_kernel(const int32_t* __restrict__ live, const int32_t* __restrict__ fixed,
                                      const int32_t* __restrict__ zh_inv, const int32_t* __restrict__ dpow,
                                      const int32_t* __restrict__ sc, const int32_t* __restrict__ zw,
                                      int64_t zw_stride, int32_t* __restrict__ out, int64_t m,
                                      int64_t shift) {
  const int64_t ls = 5 * m, fs = 9 * m;
  uint32_t beta[8], gamma[8];
  load<Fr>(beta, sc + 0, 6);
  load<Fr>(gamma, sc + 1, 6);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < m;
       i += (int64_t)gridDim.x * blockDim.x) {
    uint32_t a[8], b[8], c[8], x[8], t[8], u[8], gate[8], perm[8];
    load<Fr>(a, live + i, ls);
    load<Fr>(b, live + m + i, ls);
    load<Fr>(c, live + 2 * m + i, ls);
    // gate = a ql + b qr + a b qm + c qo + pi + qc
    load<Fr>(x, fixed + 3 * m + i, fs);
    mul<Fr>(gate, a, x);
    load<Fr>(x, fixed + 4 * m + i, fs);
    mul<Fr>(t, b, x);
    add<Fr>(gate, gate, t);
    load<Fr>(x, fixed + 5 * m + i, fs);
    mul<Fr>(t, a, b);
    mul<Fr>(t, t, x);
    add<Fr>(gate, gate, t);
    load<Fr>(x, fixed + 6 * m + i, fs);
    mul<Fr>(t, c, x);
    add<Fr>(gate, gate, t);
    load<Fr>(x, live + 4 * m + i, ls);
    add<Fr>(gate, gate, x);
    load<Fr>(x, fixed + 7 * m + i, fs);
    add<Fr>(gate, gate, x);
    // perm = rlc(a, d) rlc(b, k1 d) rlc(c, k2 d) z - rlc(a, s1) rlc(b, s2) rlc(c, s3) z(w x)
    load<Fr>(x, dpow + i, m);
    rlc(perm, a, x, beta, gamma);
    load<Fr>(u, sc + 4, 6);
    mul<Fr>(u, u, x);
    rlc(t, b, u, beta, gamma);
    mul<Fr>(perm, perm, t);
    load<Fr>(u, sc + 5, 6);
    mul<Fr>(u, u, x);
    rlc(t, c, u, beta, gamma);
    mul<Fr>(perm, perm, t);
    load<Fr>(x, live + 3 * m + i, ls);  // z, kept in x for the first-row term
    mul<Fr>(perm, perm, x);
    load<Fr>(u, fixed + i, fs);
    rlc(a, a, u, beta, gamma);
    load<Fr>(u, fixed + m + i, fs);
    rlc(t, b, u, beta, gamma);
    mul<Fr>(a, a, t);
    load<Fr>(u, fixed + 2 * m + i, fs);
    rlc(t, c, u, beta, gamma);
    mul<Fr>(a, a, t);
    load<Fr>(u, zw + (i + shift) % m, zw_stride);
    mul<Fr>(a, a, u);
    sub<Fr>(perm, perm, a);
    load<Fr>(u, sc + 2, 6);
    mul<Fr>(perm, perm, u);
    // first = (z - 1) l1
    set_one<Fr>(t);
    sub<Fr>(t, x, t);
    load<Fr>(u, fixed + 8 * m + i, fs);
    mul<Fr>(t, t, u);
    load<Fr>(u, sc + 3, 6);
    mul<Fr>(t, t, u);
    add<Fr>(perm, perm, t);
    add<Fr>(gate, gate, perm);
    load<Fr>(u, zh_inv + i, m);
    mul<Fr>(gate, gate, u);
    store<Fr>(out + i, m, gate);
  }
}

}  // namespace

extern "C" int bpt_field_op(int field, int op, const void* a, long long a_div, long long a_mod,
                            const void* b, long long b_div, long long b_mod, void* out,
                            long long n, void* stream) {
  const int threads = 256;
  const int grid = grid_for(n, threads);
  cudaStream_t s = (cudaStream_t)stream;
  const bool flat = a_div == 1 && a_mod == n && b_div == 1 && b_mod == n;
#define BPT_FIELD_OP(F, FLAT)                                                              \
  field_op_kernel<F, FLAT><<<grid, threads, 0, s>>>(op, (const int32_t*)a, a_div, a_mod,  \
                                                     (const int32_t*)b, b_div, b_mod,      \
                                                     (int32_t*)out, n)
  if (field == 0) {
    if (flat) BPT_FIELD_OP(Fr, true); else BPT_FIELD_OP(Fr, false);
  } else {
    if (flat) BPT_FIELD_OP(Fq, true); else BPT_FIELD_OP(Fq, false);
  }
#undef BPT_FIELD_OP
  return (int)cudaGetLastError();
}

extern "C" int bpt_field_select(int L, const void* cond, long long c_div, long long c_mod,
                                const void* a, long long a_div, long long a_mod, const void* b,
                                long long b_div, long long b_mod, void* out, long long n,
                                void* stream) {
  const int threads = 256;
  select_kernel<<<grid_for(n, threads), threads, 0, (cudaStream_t)stream>>>(
      L, (const bool*)cond, c_div, c_mod, (const int32_t*)a, a_div, a_mod, (const int32_t*)b,
      b_div, b_mod, (int32_t*)out, n);
  return (int)cudaGetLastError();
}

// a, out: (L, n); exponent: ``words`` 32-bit words on the HOST, little-endian,
// not zero, at most 12 words.
extern "C" int bpt_field_pow(int field, const void* a, void* out, long long n,
                             const unsigned int* exponent, int words, void* stream) {
  Exponent e;
  e.top = -1;
  for (int i = 0; i < 12; i++) {
    e.w[i] = i < words ? exponent[i] : 0u;
    for (int bit = 0; bit < 32; bit++)
      if ((e.w[i] >> bit) & 1u) e.top = 32 * i + bit;
  }
  if (e.top < 0 || words > 12) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    field_pow_kernel<Fr><<<grid_for(n, threads), threads, 0, s>>>((const int32_t*)a, (int32_t*)out, n, e);
  else
    field_pow_kernel<Fq><<<grid_for(n, threads), threads, 0, s>>>((const int32_t*)a, (int32_t*)out, n, e);
  return (int)cudaGetLastError();
}

// x, out: (L, rows, n); total: (L, rows) or null; totals, prefix: scratch of
// (L, rows, ceil(n / 256)) each, unused when n <= 256. op: 0 product, 1 sum.
extern "C" int bpt_field_scan(int field, int op, const void* x, void* out, void* total,
                              void* totals, void* prefix, long long rows, long long n,
                              int reverse, int exclusive, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define BPT_SCAN(F, OP)                                                                     \
  return scan_launch<F, OP>((const int32_t*)x, (int32_t*)out, (int32_t*)total,              \
                            (int32_t*)totals, (int32_t*)prefix, rows, n, reverse, exclusive, s)
  if (field == 0) {
    if (op == SCAN_MUL) BPT_SCAN(Fr, SCAN_MUL); else BPT_SCAN(Fr, SCAN_ADD);
  } else {
    if (op == SCAN_MUL) BPT_SCAN(Fq, SCAN_MUL); else BPT_SCAN(Fq, SCAN_ADD);
  }
#undef BPT_SCAN
}

// z: (L, 1) Montgomery; out: (L, n) = z^0 .. z^(n-1).
extern "C" int bpt_field_pow_table(int field, const void* z, void* out, long long n, void* stream) {
  const long long tile = POW_THREADS * POW_RUN;
  const unsigned grid = (unsigned)((n + tile - 1) / tile);
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    pow_table_kernel<Fr><<<grid, POW_THREADS, 0, s>>>((const int32_t*)z, (int32_t*)out, n);
  else
    pow_table_kernel<Fq><<<grid, POW_THREADS, 0, s>>>((const int32_t*)z, (int32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int bpt_grand_product_fg(const void* a, const void* b, const void* c, const void* s1,
                                    const void* s2, const void* s3, const void* roots,
                                    const void* sc, void* f, void* g, long long n, void* stream) {
  const int threads = 128;
  grand_product_fg_kernel<<<grid_for(n, threads), threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (const int32_t*)c, (const int32_t*)s1,
      (const int32_t*)s2, (const int32_t*)s3, (const int32_t*)roots, (const int32_t*)sc,
      (int32_t*)f, (int32_t*)g, n);
  return (int)cudaGetLastError();
}

// z(w x) is read from zw (16, m) where it is given, else from live's z row.
extern "C" int bpt_round3_combine(const void* live, const void* fixed, const void* zh_inv,
                                  const void* dpow, const void* sc, const void* zw, void* out,
                                  long long m, long long shift, void* stream) {
  const int threads = 128;
  const int32_t* zrow = zw ? (const int32_t*)zw : (const int32_t*)live + 3 * m;
  round3_combine_kernel<<<grid_for(m, threads), threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)live, (const int32_t*)fixed, (const int32_t*)zh_inv, (const int32_t*)dpow,
      (const int32_t*)sc, zrow, zw ? m : 5 * m, (int32_t*)out, m, shift);
  return (int)cudaGetLastError();
}
