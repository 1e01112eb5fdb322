// Sub-NTT: all log2(m) radix-2 butterfly stages of a length-m Fr NTT along
// the row axis of a (16, K, m, B) Montgomery batch, in shared memory.
//
// Replaces: ntt_sub_pallas + _ntt_sub_kernel + _stage_twiddles
// (baby_plonk_tpu/ops/pallas_kernels.py:310-389), which ran the Pease stages
// of one (16, m, B) block resident in VMEM. Same contract at the wrapper
// (ops/kernels.py::ntt_sub): Montgomery in, rows out in BIT-REVERSED order,
// no 1/m scaling; the batch axes K and B are new, so every NTT of a prove
// (batched iNTTs and round 3 included) runs here. The four-step composition
// (ntt_sub_pallas_4step, :392-432) is ops/kernels.py::ntt_sub_4step around
// this kernel and the elementwise multiply of field.cu.
//
// Bound on this card: the Montgomery multiplies (m/2 log2 m per column,
// 64 32x32->64 products each plus the reduction) and the two passes over
// device memory (64 bytes per element in and out).
//
// Simple design: one block owns C whole columns (m * C = 1024 elements at
// most, 32 KB of shared memory as 8-word elements), loads them once, runs
// the Gentleman-Sande decimation-in-frequency stages in place with one
// butterfly per thread per stage and a barrier between stages, and writes
// the columns back. The stage-s twiddle of butterfly offset k is w^(k 2^s),
// read from a (16, m/2) table of powers of the sub-root. The output order
// and values equal the Pease formulation's: both are the DFT, bit-reversed.
#include "field.cuh"

using namespace bpt;

namespace {

__global__ void ntt_sub_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                               const int32_t* __restrict__ tw, int64_t K, int m, int64_t B,
                               int C) {
  extern __shared__ uint32_t sh[];  // [m * C][8]
  const int64_t col_blocks = B / C;
  const int64_t k = blockIdx.x / col_blocks;
  const int64_t b0 = (blockIdx.x % col_blocks) * C;
  const int64_t stride = K * m * B;  // limb stride
  const int64_t base = k * m * B + b0;
  const int total = m * C;

  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int i = e / C, c = e % C;
    uint32_t x[8];
    load<Fr>(x, in + base + (int64_t)i * B + c, stride);
#pragma unroll
    for (int w = 0; w < 8; w++) sh[e * 8 + w] = x[w];
  }
  __syncthreads();

  const int half = m / 2;
  const int c = threadIdx.x % C;
  const int j = threadIdx.x / C;  // butterfly index in [0, m/2)
  for (int len = half, step = 1; len >= 1; len >>= 1, step <<= 1) {
    const int off = j % len;
    const int i0 = (j / len) * 2 * len + off;
    const int i1 = i0 + len;
    uint32_t u[8], v[8], s[8], d[8], w[8];
#pragma unroll
    for (int q = 0; q < 8; q++) {
      u[q] = sh[(i0 * C + c) * 8 + q];
      v[q] = sh[(i1 * C + c) * 8 + q];
    }
    add<Fr>(s, u, v);
    sub<Fr>(d, u, v);
    load<Fr>(w, tw + off * step, half);
    mul<Fr>(d, d, w);
#pragma unroll
    for (int q = 0; q < 8; q++) {
      sh[(i0 * C + c) * 8 + q] = s[q];
      sh[(i1 * C + c) * 8 + q] = d[q];
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int i = e / C, cc = e % C;
    uint32_t x[8];
#pragma unroll
    for (int w = 0; w < 8; w++) x[w] = sh[e * 8 + w];
    store<Fr>(out + base + (int64_t)i * B + cc, stride, x);
  }
}

}  // namespace

// in/out: (16, K, m, B) int32 limbs; tw: (16, m/2) Montgomery powers of the
// sub-root; C columns per block (a power of two dividing B, m * C <= 1024).
extern "C" int bpt_ntt_sub(const void* in, void* out, const void* tw, long long K, long long m,
                           long long B, long long C, void* stream) {
  const int threads = (int)(m / 2 * C);
  const size_t smem = (size_t)m * C * 8 * sizeof(uint32_t);
  const long long blocks = K * (B / C);
  ntt_sub_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)in, (int32_t*)out, (const int32_t*)tw, K, (int)m, B, (int)C);
  return (int)cudaGetLastError();
}
