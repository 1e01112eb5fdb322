// Fr and Fq arithmetic for sm_90a: add, sub, neg, Montgomery product and
// square over 32-bit words, one set of templates for both fields.
//
// Bound on this card: the integer multiply-add pipe, and before that the
// latency of the chain. A product written as 64-bit C arithmetic
// ((uint64_t)a * b + t + c) costs several instructions a word and one long
// dependent chain; the card has multiply-adds that take and leave a carry
// (mad.lo.cc / madc.hi.cc) and add-with-carry. So every operation here is
// one inline-PTX carry chain from field_asm.cuh, which the build writes
// from baby_plonk_tpu_torch/ops/field_asm.py (the even/odd-word split known
// from the ZPrize MSM entries and sppark's mont_t: two independent chains a
// row, no carry word between the partial products; the design and its
// bounds are set out in that file). sqr forms the cross products once.
//
// Lazy reduction (Fq only): p < 2^381 leaves three bits in 12 words, and
// R = 2^384 > 9.8 p. add_lazy leaves a sum of two canonical values
// unreduced (< 2p); mul takes operands a < 4p, b < 2^384 with a b < R p and
// returns the canonical product, so a sum may go straight into a product.
// Everything else takes and returns canonical values (< p).
//
// Montgomery radix: R = 2^(32 N) = 2^(16 L), the radix of the JAX package
// (baby_plonk_tpu/ops/limbs.py, R = 2^(16 L)), so a Montgomery value is the
// same integer in both packages.
//
// Memory layout (the port's tensors): an element batch is an int32 array
// (L, n) of 16-bit limbs, limb-major; load/store repack two limbs into one
// 32-bit word in registers.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#include "field_asm.cuh"

namespace bpt {

// BLS12-381 scalar field r, 255 bits, 8 words (the modulus itself is an
// immediate of the carry chains in field_asm.cuh).
static __constant__ uint32_t FR_R2[8] = {
    0xf3f29c6du, 0xc999e990u, 0x87925c23u, 0x2b6cedcbu,
    0x7254398fu, 0x05d31496u, 0x9f59ff11u, 0x0748d9d9u};
static __constant__ uint32_t FR_ONE[8] = {
    0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
    0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};
static __constant__ uint32_t FR_PM2[8] = {
    0xffffffffu, 0xfffffffeu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};

// BLS12-381 base field p, 381 bits, 12 words.
static __constant__ uint32_t FQ_R2[12] = {
    0x1c341746u, 0xf4df1f34u, 0x09d104f1u, 0x0a76e6a6u,
    0x4c95b6d5u, 0x8de5476cu, 0x939d83c0u, 0x67eb88a9u,
    0xb519952du, 0x9a793e85u, 0x92cae3aau, 0x11988fe5u};
static __constant__ uint32_t FQ_ONE[12] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
    0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
    0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
static __constant__ uint32_t FQ_PM2[12] = {
    0xffffaaa9u, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
    0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
    0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};

struct Fr {
  static constexpr int N = 8;         // 32-bit words
  static constexpr int L = 16;        // 16-bit limbs in memory
  static __device__ __forceinline__ uint32_t r2(int i) { return FR_R2[i]; }
  static __device__ __forceinline__ uint32_t one(int i) { return FR_ONE[i]; }
  static __device__ __forceinline__ uint32_t pm2(int i) { return FR_PM2[i]; }
  static __device__ __forceinline__ void mul(uint32_t* r, const uint32_t* a, const uint32_t* b) { ptx::fr_mul(r, a, b); }
  static __device__ __forceinline__ void sqr(uint32_t* r, const uint32_t* a) { ptx::fr_sqr(r, a); }
  static __device__ __forceinline__ void add(uint32_t* r, const uint32_t* a, const uint32_t* b) { ptx::fr_add(r, a, b); }
  static __device__ __forceinline__ void sub(uint32_t* r, const uint32_t* a, const uint32_t* b) { ptx::fr_sub(r, a, b); }
};

struct Fq {
  static constexpr int N = 12;
  static constexpr int L = 24;
  static __device__ __forceinline__ uint32_t r2(int i) { return FQ_R2[i]; }
  static __device__ __forceinline__ uint32_t one(int i) { return FQ_ONE[i]; }
  static __device__ __forceinline__ uint32_t pm2(int i) { return FQ_PM2[i]; }
  static __device__ __forceinline__ void mul(uint32_t* r, const uint32_t* a, const uint32_t* b) { ptx::fq_mul(r, a, b); }
  static __device__ __forceinline__ void sqr(uint32_t* r, const uint32_t* a) { ptx::fq_sqr(r, a); }
  static __device__ __forceinline__ void add(uint32_t* r, const uint32_t* a, const uint32_t* b) { ptx::fq_add(r, a, b); }
  static __device__ __forceinline__ void sub(uint32_t* r, const uint32_t* a, const uint32_t* b) { ptx::fq_sub(r, a, b); }
};

// -- memory <-> registers ----------------------------------------------------

// Element at ``src`` with limb stride ``stride`` (elements) -> N words.
template <class F>
__device__ __forceinline__ void load(uint32_t r[F::N], const int32_t* src, int64_t stride) {
#pragma unroll
  for (int i = 0; i < F::N; i++)
    r[i] = (uint32_t)src[(2 * i) * stride] | ((uint32_t)src[(2 * i + 1) * stride] << 16);
}

template <class F>
__device__ __forceinline__ void store(int32_t* dst, int64_t stride, const uint32_t r[F::N]) {
#pragma unroll
  for (int i = 0; i < F::N; i++) {
    dst[(2 * i) * stride] = (int32_t)(r[i] & 0xffffu);
    dst[(2 * i + 1) * stride] = (int32_t)(r[i] >> 16);
  }
}

template <class F>
__device__ __forceinline__ void copy(uint32_t r[F::N], const uint32_t a[F::N]) {
#pragma unroll
  for (int i = 0; i < F::N; i++) r[i] = a[i];
}

template <class F>
__device__ __forceinline__ void set_zero(uint32_t r[F::N]) {
#pragma unroll
  for (int i = 0; i < F::N; i++) r[i] = 0;
}

template <class F>
__device__ __forceinline__ void set_one(uint32_t r[F::N]) {  // Montgomery 1
#pragma unroll
  for (int i = 0; i < F::N; i++) r[i] = F::one(i);
}

template <class F>
__device__ __forceinline__ bool is_zero(const uint32_t a[F::N]) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < F::N; i++) acc |= a[i];
  return acc == 0;
}

// -- modular arithmetic ------------------------------------------------------
// Results may alias operands: an asm statement reads every operand before
// it writes a result.

template <class F>
__device__ __forceinline__ void add(uint32_t r[F::N], const uint32_t a[F::N], const uint32_t b[F::N]) {
  F::add(r, a, b);
}

// r = a + b, unreduced: < 2p for canonical a, b (fits: 2p < 2^382).
__device__ __forceinline__ void add_lazy(uint32_t r[12], const uint32_t a[12], const uint32_t b[12]) {
  ptx::fq_add_lazy(r, a, b);
}

template <class F>
__device__ __forceinline__ void sub(uint32_t r[F::N], const uint32_t a[F::N], const uint32_t b[F::N]) {
  F::sub(r, a, b);
}

template <class F>
__device__ __forceinline__ void neg(uint32_t r[F::N], const uint32_t a[F::N]) {
  uint32_t z[F::N];
  set_zero<F>(z);
  F::sub(r, z, a);  // 0 - a borrows unless a = 0, and the borrow adds p
}

// Montgomery product r = a b R^-1 mod p, canonical.
template <class F>
__device__ __forceinline__ void mul(uint32_t r[F::N], const uint32_t a[F::N], const uint32_t b[F::N]) {
  F::mul(r, a, b);
}

// Montgomery square r = a a R^-1 mod p of a canonical a.
template <class F>
__device__ __forceinline__ void sqr(uint32_t r[F::N], const uint32_t a[F::N]) {
  F::sqr(r, a);
}

// r = a^(p-2) = a^-1 (Montgomery in and out; 0 -> 0), left-to-right.
template <class F>
__device__ __forceinline__ void inverse(uint32_t r[F::N], const uint32_t a[F::N]) {
  uint32_t acc[F::N];
  set_one<F>(acc);
  for (int w = F::N - 1; w >= 0; w--) {
    const uint32_t e = F::pm2(w);
#pragma unroll 1
    for (int bit = 31; bit >= 0; bit--) {
      sqr<F>(acc, acc);
      if ((e >> bit) & 1u) mul<F>(acc, acc, a);
    }
  }
  copy<F>(r, acc);
}

// r = 12 a (b3 of y^2 = x^3 + 4) by additions.
template <class F>
__device__ __forceinline__ void mul12(uint32_t r[F::N], const uint32_t a[F::N]) {
  uint32_t a4[F::N], a8[F::N];
  add<F>(a4, a, a);
  add<F>(a4, a4, a4);
  add<F>(a8, a4, a4);
  add<F>(r, a8, a4);
}

}  // namespace bpt
