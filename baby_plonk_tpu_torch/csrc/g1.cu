// Elementwise G1 point addition r_i = p_i + q_i and doubling r_i = 2 p_i
// over (24, n) projective Montgomery batches: the step of the MSM's
// partial-sum tree reduction, and the passes of the sorted-bucket Pippenger
// MSM (ops/msm_pippenger.py): its additions run over all n sorted points (the
// segmented scan) and over the 2^c buckets (suffix sums and tree); its
// doublings run on one lane, the running total shifted by c bits per window.
//
// Replaces: the padd tree of _reduce_partials (baby_plonk_tpu/ops/
// pallas_kernels.py:138-156) and g1_vec.tree_reduce (ops/g1_vec.py:298),
// which the fixed-base Pallas MSM ran in XLA after its kernel, and
// msm._combine_partials (ops/msm.py:101-116) across chunks; and the XLA
// elementwise g1_vec.padd / g1_vec.pdouble (ops/g1_vec.py:132, :165) inside
// msm_pippenger (ops/msm_pippenger.py:58, :76, :116, :122).
//
// Bound on this card: the 12 Fq Montgomery products per addition (8 per
// doubling) on the integer multiply-add pipe; an addition reads 6 and
// writes 3 coordinates of 96 bytes per lane, a doubling reads 3 and writes 3.
//
// Simple design: one thread per lane; ops/g1_vec.py::tree_reduce launches
// one halving level at a time.
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
    g1_add(p, p, q);
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
    g1_double(p, p);
    g1_store(x3, y3, z3, i, n, p);
  }
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
