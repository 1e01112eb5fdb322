// Powers of tau on the device: lane i computes s_i * G for a raw Fr scalar
// s_i = tau^i, the G1 half of the KZG SRS.
//
// Replaces: _fixed_base_kernel / powers_of_tau_device (baby_plonk_tpu/ops/
// srs.py:23-82), an XLA kernel with no Pallas form. Same algorithm and
// order: LSB-first double-and-add over 255 bits, acc <- acc + base where
// the bit is set, base <- 2 base, with the complete projective formulas of
// g1.cuh — so the projective outputs equal the JAX package's.
//
// Bound on this card: ~255 additions and 255 doublings per lane (~21 Fq
// Montgomery products a step) on the integer multiply-add pipe; memory
// traffic is one scalar in and one point out per lane.
//
// Simple design: one thread per lane; every lane recomputes the doubling
// chain of the same base point.
#include "g1.cuh"

using namespace bpt;

namespace {

// scalars (16, n) raw limbs; base (24, 3): the base point's X, Y, Z columns
// (Montgomery); out (24, n) x3.
__global__ void powers_of_tau_kernel(const int32_t* __restrict__ scalars, const int32_t* base,
                                     int64_t n, int32_t* ox, int32_t* oy, int32_t* oz) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  G1P acc, b;
  g1_identity(acc);
  load<Fq>(b.x, base + 0, 3);
  load<Fq>(b.y, base + 1, 3);
  load<Fq>(b.z, base + 2, 3);
  for (int bit = 0; bit < 255; bit++) {
    if ((scalars[(bit >> 4) * n + i] >> (bit & 15)) & 1) g1_add(acc, acc, b);
    g1_double(b, b);
  }
  g1_store(ox, oy, oz, i, n, acc);
}

}  // namespace

extern "C" int bpt_powers_of_tau(const void* scalars, const void* base, long long n, void* ox,
                                 void* oy, void* oz, void* stream) {
  const int threads = 64;
  powers_of_tau_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                         (cudaStream_t)stream>>>((const int32_t*)scalars, (const int32_t*)base, n,
                                                 (int32_t*)ox, (int32_t*)oy, (int32_t*)oz);
  return (int)cudaGetLastError();
}
