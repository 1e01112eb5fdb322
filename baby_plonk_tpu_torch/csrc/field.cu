// Elementwise Fr / Fq field kernels: Montgomery multiply, add, sub, neg,
// to/from Montgomery form, and lane select.
//
// Replaces: mont_mul_pallas (baby_plonk_tpu/ops/pallas_kernels.py:43, a tiled
// elementwise Montgomery product) and the XLA elementwise ops it stood beside
// (ops/limbs.py: add_mod/sub_mod/neg_mod :325-345, to_mont/from_mont
// :812-824, select :829). In the port this is the pointwise path of the
// whole prove: grand product, round-3 combine, DPoly arithmetic, NTT cross
// twiddles, power tables.
//
// Bound on this card: device-memory bandwidth for add/sub (a 16-limb int32
// element is 64 bytes each way, a handful of integer ops), the integer
// multiply-add pipe for the Montgomery product (64 32x32->64 products for Fr,
// 144 for Fq, plus as many for the reduction, per element).
//
// Simple design: one thread per element in a grid-stride loop; each thread
// repacks its element's 16-bit limbs into 32-bit words in registers, runs the
// CIOS product fully unrolled, and writes the limbs back. Limb-major layout
// makes every limb load coalesced across a warp. Broadcasting is an index map:
// output element i reads operand element (i / div) % mod.
#include "field.cuh"

using namespace bpt;

namespace {

enum Op { MUL = 0, ADD = 1, SUB = 2, NEG = 3, TO_MONT = 4, FROM_MONT = 5 };

template <class F>
__global__ void field_op_kernel(int op, const int32_t* __restrict__ a, int64_t a_div, int64_t a_mod,
                                const int32_t* __restrict__ b, int64_t b_div, int64_t b_mod,
                                int32_t* __restrict__ out, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    uint32_t x[F::N], y[F::N], r[F::N];
    load<F>(x, a + (i / a_div) % a_mod, a_mod);
    switch (op) {
      case MUL:
        load<F>(y, b + (i / b_div) % b_mod, b_mod);
        mul<F>(r, x, y);
        break;
      case ADD:
        load<F>(y, b + (i / b_div) % b_mod, b_mod);
        add<F>(r, x, y);
        break;
      case SUB:
        load<F>(y, b + (i / b_div) % b_mod, b_mod);
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
      default:  // FROM_MONT
#pragma unroll
        for (int k = 0; k < F::N; k++) y[k] = k == 0 ? 1u : 0u;
        mul<F>(r, x, y);
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

}  // namespace

extern "C" int bpt_field_op(int field, int op, const void* a, long long a_div, long long a_mod,
                            const void* b, long long b_div, long long b_mod, void* out,
                            long long n, void* stream) {
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    field_op_kernel<Fr><<<grid_for(n, threads), threads, 0, s>>>(
        op, (const int32_t*)a, a_div, a_mod, (const int32_t*)b, b_div, b_mod, (int32_t*)out, n);
  else
    field_op_kernel<Fq><<<grid_for(n, threads), threads, 0, s>>>(
        op, (const int32_t*)a, a_div, a_mod, (const int32_t*)b, b_div, b_mod, (int32_t*)out, n);
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
