// Variable-base bit-serial MSM: per lane the whole double-and-add bit loop,
// then the halving tree inside the tile; one partial point per tile.
//
// Replaces: msm_pallas_partials + _msm_tile_kernel (baby_plonk_tpu/ops/
// pallas_kernels.py:67-137), the fused tile kernel of the generic commit
// MSM, and its XLA twin _msm_kernel (ops/msm.py:28-51). The per-tile
// partials are summed by the g1.cu addition launcher
// (ops/g1_vec.py::combine_partials, the counterpart of _reduce_partials,
// pallas_kernels.py:139-156).
//
// Per lane i, LSB first over the bits of scalar s_i:
//   acc = bit ? acc + base : acc;  base = 2 base
// with acc starting at the identity (0 : 1 : 0) and base at P_i. Both
// formulas are complete, so the identity accumulator and a padded lane (a
// copy of point 0 with a zero scalar) take no special case. Where the bit is
// 0 the addition is skipped: the result is then acc itself, limb for limb,
// which is what the plain version's select keeps. 255 steps: bit 255 of a
// canonical Fr scalar is 0, and the doubling after the last step is unused.
//
// Bound on this card: operations. A lane runs 254 doublings (8 Fq
// Montgomery products each) and one addition (12 products) per set bit, on
// the integer multiply-add pipe; it reads 3 x 96 + 32 bytes once.
//
// Simple design: one thread per lane, one block per tile (the tile is the
// block size, a power of two up to 256). The in-tile reduction goes through
// shared memory (256 points x 144 bytes = 36 KB, word-major so that a warp's
// accesses fall on distinct banks) level by level, lane i taking lane
// i + half: the order of _msm_tile_kernel (:91-98), so the partial equals
// the plain version's (X, Y, Z) limb for limb.
#include "g1.cuh"

using namespace bpt;

namespace {

constexpr int NBITS = 255;
constexpr int MAX_TILE = 256;
constexpr int WORDS = 36;  // one projective point

__device__ __forceinline__ void smem_put(uint32_t* sm, int lane, const G1P& p) {
#pragma unroll
  for (int w = 0; w < 12; w++) {
    sm[w * MAX_TILE + lane] = p.x[w];
    sm[(12 + w) * MAX_TILE + lane] = p.y[w];
    sm[(24 + w) * MAX_TILE + lane] = p.z[w];
  }
}

__device__ __forceinline__ void smem_get(G1P& p, const uint32_t* sm, int lane) {
#pragma unroll
  for (int w = 0; w < 12; w++) {
    p.x[w] = sm[w * MAX_TILE + lane];
    p.y[w] = sm[(12 + w) * MAX_TILE + lane];
    p.z[w] = sm[(24 + w) * MAX_TILE + lane];
  }
}

// points (24, n) x3 Montgomery projective; scalars (16, n) raw limbs;
// out (24, n / tile) x3. blockDim.x == tile, gridDim.x == n / tile.
__global__ void __launch_bounds__(MAX_TILE)
msm_bitserial_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                     const int32_t* __restrict__ pz, const int32_t* __restrict__ scalars,
                     int64_t n, int32_t* ox, int32_t* oy, int32_t* oz) {
  __shared__ uint32_t sm[WORDS * MAX_TILE];
  const int tid = threadIdx.x;
  const int tile = blockDim.x;
  const int64_t lane = blockIdx.x * (int64_t)tile + tid;

  G1P acc, base;
  g1_identity(acc);
  g1_load(base, px, py, pz, lane, n);
  for (int bit = 0; bit < NBITS; bit++) {
    const uint32_t limb = (uint32_t)scalars[(bit >> 4) * n + lane];
    if ((limb >> (bit & 15)) & 1u) g1_add(acc, acc, base);
    if (bit + 1 < NBITS) g1_double(base, base);
  }

  smem_put(sm, tid, acc);
  for (int half = tile >> 1; half >= 1; half >>= 1) {
    __syncthreads();
    if (tid < half) {
      smem_get(base, sm, tid + half);
      g1_add(acc, acc, base);
      smem_put(sm, tid, acc);
    }
  }
  if (tid == 0) g1_store(ox, oy, oz, blockIdx.x, gridDim.x, acc);
}

}  // namespace

extern "C" int bpt_msm_bitserial(const void* px, const void* py, const void* pz,
                                 const void* scalars, long long n, int tile, void* ox, void* oy,
                                 void* oz, void* stream) {
  if (tile < 1 || tile > MAX_TILE || (tile & (tile - 1)) || n % tile) return (int)cudaErrorInvalidValue;
  msm_bitserial_kernel<<<(unsigned)(n / tile), tile, 0, (cudaStream_t)stream>>>(
      (const int32_t*)px, (const int32_t*)py, (const int32_t*)pz, (const int32_t*)scalars, n,
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz);
  return (int)cudaGetLastError();
}
