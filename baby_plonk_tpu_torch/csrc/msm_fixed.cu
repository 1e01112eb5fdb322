// Fixed-base KZG commit MSM: subset-sum table build, affine normalization,
// the windowed Horner loop over the tables, and the join of the windows.
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
// Bound on this card: operations. A Horner step is a doubling and a mixed
// addition, 19 Fq products on the integer multiply-add pipe, against 96
// bytes of table. Before the pipe, the length of one lane's dependent chain
// binds: 255 steps of about 21 us each, whatever the number of lanes, until
// the card's 50,000 resident lanes are filled.
//
// Design of the Horner loop: the 255 bits are cut into W windows of S =
// ceil(255 / W) bits, and a lane is (scalar set, window, group): it runs its
// window's steps, MSB first, acc = 2 acc + T[g][bits of the 8 scalars], with
// acc in registers (g1.cuh inlines the formulas). The lanes of a (set,
// window) are summed by the addition tree, and bpt_msm_join runs the short
// Horner over the window sums, S doublings and an addition a window, one
// thread a set: that serial tail is the price of the W-fold shorter chains.
// W = 1 is the unsplit loop. A lane loads one 16-bit limb of its 8 scalars
// per 16 steps (two 16-byte loads) and cuts the step's 8-bit index from
// registers; it skips the (0, 0) marker (the mixed addition is not complete
// for an identity operand). Bit 255 of a canonical Fr scalar is 0.
//
// The build is one thread per group (the write-once recurrence T[idx] =
// T[idx - msb] + P_msb in idx order, projective, in a limb-major scratch)
// and one thread per entry for the normalization (Fermat inversion of Z,
// with the dedicated square), which writes the packed entry. Once per SRS.
#include "g1.cuh"

using namespace bpt;

namespace {

constexpr int GROUP = 8;
constexpr int NB = 1 << GROUP;
constexpr int NBITS = 255;
constexpr int ENTRY = 24;  // 32-bit words of one packed entry

// points: (24, 8G) x3 projective Montgomery; scratch: (24, G, 256) x3.
__global__ void build_tables_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                                    const int32_t* __restrict__ pz, int64_t G, int32_t* tx,
                                    int32_t* ty, int32_t* tz) {
  const int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (g >= G) return;
  const int64_t tstride = G * NB;
  const int64_t row = g * NB;
  G1P acc;
  g1_identity(acc);
  g1_store(tx, ty, tz, row, tstride, acc);
#pragma unroll 1
  for (int idx = 1; idx < NB; idx++) {
    const int msb = 31 - __clz(idx);
    G1P pt;
    g1_load(acc, tx, ty, tz, row + (idx - (1 << msb)), tstride);
    g1_load(pt, px, py, pz, g * GROUP + msb, G * GROUP);
    g1_add(acc, pt);
    g1_store(tx, ty, tz, row + idx, tstride, acc);
  }
}

// scratch (24, entries) x3 projective -> packed (entries, 24): (X / Z, Y / Z),
// or (0, 0) where Z = 0.
__global__ void normalize_tables_kernel(const int32_t* __restrict__ tx, const int32_t* __restrict__ ty,
                                        const int32_t* __restrict__ tz, int64_t entries,
                                        uint32_t* __restrict__ packed) {
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < entries;
       e += (int64_t)gridDim.x * blockDim.x) {
    uint32_t x[12], y[12], z[12];
    load<Fq>(z, tz + e, entries);
    if (is_zero<Fq>(z)) {
      set_zero<Fq>(x);
      set_zero<Fq>(y);
    } else {
      uint32_t zi[12];
      inverse<Fq>(zi, z);
      load<Fq>(x, tx + e, entries);
      load<Fq>(y, ty + e, entries);
      mul<Fq>(x, x, zi);
      mul<Fq>(y, y, zi);
    }
    uint4* dst = reinterpret_cast<uint4*>(packed + e * ENTRY);
#pragma unroll
    for (int k = 0; k < 3; k++) {
      dst[k] = make_uint4(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]);
      dst[3 + k] = make_uint4(y[4 * k], y[4 * k + 1], y[4 * k + 2], y[4 * k + 3]);
    }
  }
}

// packed tables (Gt, 256, 24); scalars (16, P, 8G) raw limbs; out
// (24, P, W, G) x3. Lane = ((p W + w) G + g) runs bits [w S, min((w+1) S, 255)).
__global__ void __launch_bounds__(128)
msm_fixed_kernel(const uint32_t* __restrict__ packed, const int32_t* __restrict__ scalars,
                 int64_t P, int64_t G, int W, int S, int32_t* ox, int32_t* oy, int32_t* oz) {
  const int64_t lane = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t lanes = P * W * G;
  if (lane >= lanes) return;
  const int64_t g = lane % G;
  const int w = (int)((lane / G) % W);
  const int64_t p = lane / (G * W);
  const int64_t sstride = P * G * GROUP;  // scalar limb stride
  const int32_t* sc = scalars + (p * G + g) * GROUP;
  const uint32_t* table = packed + g * (int64_t)(NB * ENTRY);
  const int lo = w * S;
  const int hi = min(lo + S, NBITS);
  G1P acc;
  g1_identity(acc);
  uint32_t limb[GROUP];
  int held = -1;  // which 16-bit limb of the 8 scalars the registers hold
#pragma unroll 1
  for (int bit = hi - 1; bit >= lo; bit--) {
    if ((bit >> 4) != held) {
      held = bit >> 4;
      const uint4* src = reinterpret_cast<const uint4*>(sc + held * sstride);
      const uint4 s0 = __ldg(src), s1 = __ldg(src + 1);
      limb[0] = s0.x, limb[1] = s0.y, limb[2] = s0.z, limb[3] = s0.w;
      limb[4] = s1.x, limb[5] = s1.y, limb[6] = s1.z, limb[7] = s1.w;
    }
    const int sh = bit & 15;
    uint32_t idx = 0;
#pragma unroll
    for (int j = 0; j < GROUP; j++) idx |= ((limb[j] >> sh) & 1u) << j;
    const uint4* e = reinterpret_cast<const uint4*>(table + idx * ENTRY);
    uint32_t qx[12], qy[12];
#pragma unroll
    for (int k = 0; k < 3; k++) {
      const uint4 vx = __ldg(e + k), vy = __ldg(e + 3 + k);
      qx[4 * k] = vx.x, qx[4 * k + 1] = vx.y, qx[4 * k + 2] = vx.z, qx[4 * k + 3] = vx.w;
      qy[4 * k] = vy.x, qy[4 * k + 1] = vy.y, qy[4 * k + 2] = vy.z, qy[4 * k + 3] = vy.w;
    }
    g1_double(acc);
    if (!(is_zero<Fq>(qx) && is_zero<Fq>(qy))) g1_add_mixed(acc, qx, qy);
  }
  g1_store(ox, oy, oz, lane, lanes, acc);
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

extern "C" int bpt_msm_build_tables(const void* px, const void* py, const void* pz, long long G,
                                    void* tx, void* ty, void* tz, void* stream) {
  const int threads = 64;
  build_tables_kernel<<<blocks_for(G, threads), threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)px, (const int32_t*)py, (const int32_t*)pz, G, (int32_t*)tx, (int32_t*)ty,
      (int32_t*)tz);
  return (int)cudaGetLastError();
}

extern "C" int bpt_msm_normalize_tables(const void* tx, const void* ty, const void* tz, long long G,
                                        void* packed, void* stream) {
  const int threads = 128;
  const long long entries = G * NB;
  long long blocks = (entries + threads - 1) / threads;
  if (blocks > 65536) blocks = 65536;
  normalize_tables_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tx, (const int32_t*)ty, (const int32_t*)tz, entries, (uint32_t*)packed);
  return (int)cudaGetLastError();
}

extern "C" int bpt_msm_fixed(const void* packed, const void* scalars, long long P, long long G,
                             int W, int S, void* ox, void* oy, void* oz, void* stream) {
  if (W < 1 || S < 1 || (long long)W * S < NBITS) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  msm_fixed_kernel<<<blocks_for(P * W * G, threads), threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)packed, (const int32_t*)scalars, P, G, W, S, (int32_t*)ox, (int32_t*)oy,
      (int32_t*)oz);
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
