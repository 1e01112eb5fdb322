// Fixed-base KZG commit MSM: subset-sum table build, affine normalization,
// and the Horner loop over the tables.
//
// Replaces: msm_fixed_pallas + _fixed_indices + _msm_fixed_tile_kernel
// (baby_plonk_tpu/ops/pallas_kernels.py:185-293) and its XLA twin
// _msm_fixed_kernel_oh (ops/msm_fixed.py:197-228), the main path's commit
// MSM; and the table build _build_tables (ops/msm_fixed.py:82-131), which
// had no Pallas form. The per-lane partials are summed by the g1.cu
// addition launcher (ops/g1_vec.py::tree_reduce).
//
// Tables (the JAX layout): for group g of 8 points P_{8g..8g+7}, entry idx
// holds sum_{j in idx} P_{8g+j}, affine, in two (24, G, 256) int32 limb
// arrays tx, ty; the identity (entry 0, or a subset that cancels) is the
// off-curve marker (0, 0).
//
// Bound on this card: the Horner loop is 255 doublings + up to 255 mixed
// additions per group lane (~20 Fq Montgomery products a step), on the
// integer multiply-add pipe; its table reads are 96 random bytes per lane
// and step. The build is 255 additions and one inversion per entry, once
// per SRS.
//
// Simple design: one thread per group for the build (the write-once
// recurrence T[idx] = T[idx - msb] + P_msb in idx order, projective, with Z
// kept in a scratch array); one thread per entry for the normalization
// (Fermat inversion of Z); one thread per (scalar set, group) lane for the
// Horner loop, which derives its 8-bit table index from the 8 scalars' bits
// at every step, doubles, and mixed-adds the entry unless it is the (0, 0)
// marker (the mixed addition is not complete for an identity operand). It
// runs 255 steps, MSB first: bit 255 of a canonical Fr scalar is 0.
#include "g1.cuh"

using namespace bpt;

namespace {

constexpr int GROUP = 8;
constexpr int NB = 1 << GROUP;
constexpr int NBITS = 255;

// points: (24, 8G) x3 projective Montgomery; tables: (24, G, 256) x3.
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
  for (int idx = 1; idx < NB; idx++) {
    const int msb = 31 - __clz(idx);
    G1P base, pt;
    g1_load(base, tx, ty, tz, row + (idx - (1 << msb)), tstride);
    g1_load(pt, px, py, pz, g * GROUP + msb, G * GROUP);
    g1_add(acc, base, pt);
    g1_store(tx, ty, tz, row + idx, tstride, acc);
  }
}

// In place: (X, Y) <- (X / Z, Y / Z), or (0, 0) where Z = 0.
__global__ void normalize_tables_kernel(int32_t* tx, int32_t* ty, const int32_t* __restrict__ tz,
                                        int64_t entries) {
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
    store<Fq>(tx + e, entries, x);
    store<Fq>(ty + e, entries, y);
  }
}

// tables (24, Gt, 256); scalars (16, P, 8G) raw limbs; out (24, P, G).
__global__ void msm_fixed_kernel(const int32_t* __restrict__ tx, const int32_t* __restrict__ ty,
                                 int64_t Gt, const int32_t* __restrict__ scalars, int64_t P,
                                 int64_t G, int32_t* ox, int32_t* oy, int32_t* oz) {
  const int64_t lane = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (lane >= P * G) return;
  const int64_t p = lane / G, g = lane % G;
  const int64_t sstride = P * G * GROUP;  // scalar limb stride
  const int32_t* sc = scalars + p * G * GROUP + g * GROUP;
  const int64_t tstride = Gt * NB;
  G1P acc;
  g1_identity(acc);
  for (int bit = NBITS - 1; bit >= 0; bit--) {
    const int limb = bit >> 4, sh = bit & 15;
    int idx = 0;
#pragma unroll
    for (int j = 0; j < GROUP; j++) idx |= ((sc[limb * sstride + j] >> sh) & 1) << j;
    g1_double(acc, acc);
    uint32_t qx[12], qy[12];
    load<Fq>(qx, tx + g * NB + idx, tstride);
    load<Fq>(qy, ty + g * NB + idx, tstride);
    if (!(is_zero<Fq>(qx) && is_zero<Fq>(qy))) g1_add_mixed(acc, acc, qx, qy);
  }
  g1_store(ox, oy, oz, lane, P * G, acc);
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

extern "C" int bpt_msm_normalize_tables(void* tx, void* ty, const void* tz, long long G,
                                        void* stream) {
  const int threads = 128;
  const long long entries = G * NB;
  long long blocks = (entries + threads - 1) / threads;
  if (blocks > 65536) blocks = 65536;
  normalize_tables_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)tx, (int32_t*)ty, (const int32_t*)tz, entries);
  return (int)cudaGetLastError();
}

extern "C" int bpt_msm_fixed(const void* tx, const void* ty, long long Gt, const void* scalars,
                             long long P, long long G, void* ox, void* oy, void* oz,
                             void* stream) {
  const int threads = 64;
  msm_fixed_kernel<<<blocks_for(P * G, threads), threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tx, (const int32_t*)ty, Gt, (const int32_t*)scalars, P, G, (int32_t*)ox,
      (int32_t*)oy, (int32_t*)oz);
  return (int)cudaGetLastError();
}
