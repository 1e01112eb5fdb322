// Variable-base bit-serial MSM: per lane the whole double-and-add bit loop,
// then the halving tree inside the tile; one partial point per tile, one
// launch per MSM.
//
// Replaces: msm_pallas_partials + _msm_tile_kernel (baby_plonk_tpu/ops/
// pallas_kernels.py:67-137), the fused tile kernel of the generic commit
// MSM, and its XLA twin _msm_kernel (ops/msm.py:28-51). The per-tile
// partials are summed by the g1.cu tree kernel in one launch
// (ops/g1_vec.py::combine_partials, the counterpart of _reduce_partials,
// pallas_kernels.py:139-156).
//
// Per lane i, LSB first over the bits of scalar s_i:
//   acc = bit ? acc + base : acc;  base = 2 base
// with acc starting at the identity (0 : 1 : 0) and base at P_i. Both
// formulas are complete, so the identity accumulator takes no special case.
// Where the bit is 0 the addition is skipped: the result is then acc itself,
// limb for limb, which is what the plain version's select keeps. 255 steps:
// bit 255 of a canonical Fr scalar is 0, and the doubling after the last step
// is unused. n need be no multiple of the tile: a lane at or past n keeps the
// identity and skips its loop, which is what the plain version's padding (a
// zero scalar) leaves there.
//
// Bound on this card: operations. A lane runs 254 doublings (8 Fq
// Montgomery products each) and one addition (12 products) per set bit, on
// the integer multiply-add pipe; it reads 3 x 96 + 32 bytes once. Before the
// pipe, the length of one lane's dependent chain binds: a lane whose two
// points live on the stack, or a grid that covers half the card's SMs, runs
// at a twentieth of the bound.
//
// Design: one thread per lane, one block per tile, ONE launch over the real
// length (65,542 points are 513 tiles of 128). acc and base stay in
// registers (g1.cuh inlines the formulas), a scalar limb is loaded once per
// 16 steps, and the tile (128 by default, see ops/msm.py) lets two or more
// blocks share an SM, so that one block's tree overlaps another's bit loop.
// The in-tile reduction goes through shared memory (word-major, so that a
// warp's accesses fall on distinct banks) level by level, lane i taking lane
// i + half: the order of _msm_tile_kernel (:91-98), so the partial equals the
// plain version's (X, Y, Z) limb for limb.
#include "g1.cuh"

using namespace bpt;

namespace {

constexpr int NBITS = 255;
constexpr int MAX_TILE = 256;

// points (24, n) x3 Montgomery projective; scalars (16, n) raw limbs;
// out (24, tiles) x3 with tiles = ceil(n / tile) = gridDim.x and
// blockDim.x == tile; dynamic shared memory: 36 words a lane.
__global__ void __launch_bounds__(MAX_TILE)
msm_bitserial_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                     const int32_t* __restrict__ pz, const int32_t* __restrict__ scalars,
                     int64_t n, int32_t* ox, int32_t* oy, int32_t* oz) {
  extern __shared__ uint32_t sm[];
  const int tid = threadIdx.x;
  const int tile = blockDim.x;
  const int64_t lane = blockIdx.x * (int64_t)tile + tid;

  G1P acc, base;
  g1_identity(acc);
  if (lane < n) {
    g1_load(base, px, py, pz, lane, n);
#pragma unroll 1
    for (int limb = 0; limb < 16; limb++) {
      const uint32_t word = (uint32_t)scalars[limb * n + lane];
#pragma unroll 1
      for (int s = 0; s < 16; s++) {
        const int bit = 16 * limb + s;
        if (bit >= NBITS) break;
        if ((word >> s) & 1u) g1_add(acc, base);
        if (bit + 1 < NBITS) g1_double(base);
      }
    }
  }

  g1_smem_tree(acc, base, sm, tile, true);
  if (tid == 0) g1_store(ox, oy, oz, blockIdx.x, gridDim.x, acc);
}

}  // namespace

extern "C" int bpt_msm_bitserial(const void* px, const void* py, const void* pz,
                                 const void* scalars, long long n, int tile, void* ox, void* oy,
                                 void* oz, void* stream) {
  if (tile < 1 || tile > MAX_TILE || (tile & (tile - 1)) || n < 1) return (int)cudaErrorInvalidValue;
  const long long tiles = (n + tile - 1) / tile;
  msm_bitserial_kernel<<<(unsigned)tiles, tile, 36 * tile * sizeof(uint32_t), (cudaStream_t)stream>>>(
      (const int32_t*)px, (const int32_t*)py, (const int32_t*)pz, (const int32_t*)scalars, n,
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz);
  return (int)cudaGetLastError();
}
