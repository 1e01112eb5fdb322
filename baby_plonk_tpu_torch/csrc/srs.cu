// Powers of tau on the device: lane i computes s_i * B for a raw Fr scalar
// s_i = tau^i and the base B (the generator), the G1 half of the KZG SRS.
//
// Replaces: _fixed_base_kernel / powers_of_tau_device (baby_plonk_tpu/ops/
// srs.py:23-82), an XLA kernel with no Pallas form: an LSB-first
// double-and-add over 255 bits in every lane, which doubles the same base
// 254 times in each lane. Same group elements, other projective
// coordinates: the outputs equal the JAX package's as affine points, and
// the plain version (ops/srs.py::powers_of_tau_plain) limb for limb.
//
// Design: fixed-base windows over a table of the base's multiples. The
// doublings do not depend on the lane, so they are done once:
// ops/srs.py::doubling_chain makes Q_i = 2^i B, i < 256, by 255 launches of
// the one-point doubling (csrc/g1.cu's bpt_g1_pdouble), and the table is the
// subset-sum tables of those 256 points in groups of 8 (csrc/msm_fixed.cu's
// bpt_msm_build_tables): group k, entry d is sum_{bits j of d} 2^(8k+j) B = d 2^(8k) B, affine,
// (32, 256, 24) words, 786 KB. ops/srs.py keeps it per (device, base).
// Windows of w = 8 bits, not 4: 32 additions a lane instead of 64, and the
// table is the tables the fixed-base MSM already builds; it is read
// through L2 (96 bytes an addition), where w = 4's 92 KB would sit in
// shared memory at half the lanes' additions saved. The top window keeps
// bits 248-254: bit 255 is past the reference's 255 bits.
//
// bpt_powers_of_tau: one thread a lane, 128 a block; for each byte d_k of
// the scalar, k = 0..31, acc += T[k][d_k] by the mixed addition (11 Fq
// products, the table entry at Z = 1), skipped where d_k = 0. That is
// exact: the mixed addition of g1.cuh (RCB15 Algorithm 8) is complete in
// its projective operand, the identity and acc = +-q included, as long as
// the affine operand q is not the identity; and q = d 2^(8k) B with
// 0 < d < 256 is never the identity, since B has the prime order r > 255.
// (For a canonical scalar s, acc = +-q cannot even occur: acc is
// (s mod 2^(8k)) B, and s mod 2^(8k) < d 2^(8k) < r and
// 0 < s mod 2^(8k) + d 2^(8k) <= s < r.) Scalar 0 leaves the identity.
//
// Bound on this card: operations, 11 products for each nonzero byte, about
// 32 a lane (0.11 M multiply-adds), against 352 bytes a lane (the scalar
// in, the point out) and the table read once; the old double-and-add did
// 1.04 M a lane. The doubling chain is latency: 255 dependent doublings,
// once per card and base.
#include "g1.cuh"

using namespace bpt;

namespace {

constexpr int WINDOWS = 32;  // bytes of a scalar
constexpr int ENTRY = 24;    // 32-bit words of one packed table entry

// scalars (16, n) raw limbs; table (32, 256, 24) packed affine; out (24, n) x3.
__global__ void __launch_bounds__(128)
powers_of_tau_kernel(const int32_t* __restrict__ scalars, const uint32_t* __restrict__ table,
                     int64_t n, int32_t* ox, int32_t* oy, int32_t* oz) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  G1P acc;
  g1_identity(acc);
  uint32_t limb = 0;
#pragma unroll 1
  for (int k = 0; k < WINDOWS; k++) {
    if ((k & 1) == 0) limb = (uint32_t)__ldg(scalars + (k >> 1) * n + i);
    uint32_t d = (limb >> (8 * (k & 1))) & 0xffu;
    if (k == WINDOWS - 1) d &= 0x7fu;
    if (d) {
      const uint4* e = reinterpret_cast<const uint4*>(table + ((int64_t)k * 256 + d) * ENTRY);
      uint32_t qx[12], qy[12];
#pragma unroll
      for (int w = 0; w < 3; w++) {
        const uint4 vx = __ldg(e + w), vy = __ldg(e + 3 + w);
        qx[4 * w] = vx.x, qx[4 * w + 1] = vx.y, qx[4 * w + 2] = vx.z, qx[4 * w + 3] = vx.w;
        qy[4 * w] = vy.x, qy[4 * w + 1] = vy.y, qy[4 * w + 2] = vy.z, qy[4 * w + 3] = vy.w;
      }
      g1_add_mixed(acc, qx, qy);
    }
  }
  g1_store(ox, oy, oz, i, n, acc);
}

}  // namespace

extern "C" int bpt_powers_of_tau(const void* scalars, const void* table, long long n, void* ox,
                                 void* oy, void* oz, void* stream) {
  const int threads = 128;
  powers_of_tau_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                         (cudaStream_t)stream>>>((const int32_t*)scalars, (const uint32_t*)table, n,
                                                 (int32_t*)ox, (int32_t*)oy, (int32_t*)oz);
  return (int)cudaGetLastError();
}
