// Fr and Fq arithmetic for sm_90a: add, sub, neg and CIOS Montgomery
// multiply over 32-bit words with 64-bit products, one template for both
// fields.
//
// Montgomery radix: R = 2^(32 N) = 2^(16 L), the radix of the JAX package
// (baby_plonk_tpu/ops/limbs.py, R = 2^(16 L)), so a Montgomery value is the
// same integer in both packages. Values are canonical (< p) in and out.
//
// Memory layout (the port's tensors): an element batch is an int32 array
// (L, n) of 16-bit limbs, limb-major; load/store repack two limbs into one
// 32-bit word in registers.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace bpt {

// BLS12-381 scalar field r, 255 bits, 8 words.
static __constant__ uint32_t FR_P[8] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
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
static __constant__ uint32_t FQ_P[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
    0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
    0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
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
  static constexpr uint32_t PINV = 0xffffffffu;  // -p^-1 mod 2^32
  static __device__ __forceinline__ uint32_t p(int i) { return FR_P[i]; }
  static __device__ __forceinline__ uint32_t r2(int i) { return FR_R2[i]; }
  static __device__ __forceinline__ uint32_t one(int i) { return FR_ONE[i]; }
  static __device__ __forceinline__ uint32_t pm2(int i) { return FR_PM2[i]; }
};

struct Fq {
  static constexpr int N = 12;
  static constexpr int L = 24;
  static constexpr uint32_t PINV = 0xfffcfffdu;
  static __device__ __forceinline__ uint32_t p(int i) { return FQ_P[i]; }
  static __device__ __forceinline__ uint32_t r2(int i) { return FQ_R2[i]; }
  static __device__ __forceinline__ uint32_t one(int i) { return FQ_ONE[i]; }
  static __device__ __forceinline__ uint32_t pm2(int i) { return FQ_PM2[i]; }
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

// r = s - p if s >= p else s, for s < 2p held in N words (p < 2^(32N-1)).
template <class F>
__device__ __forceinline__ void reduce_once(uint32_t r[F::N], const uint32_t s[F::N]) {
  uint32_t d[F::N];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < F::N; i++) {
    uint64_t t = (uint64_t)s[i] - F::p(i) - borrow;
    d[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 32) & 1u;
  }
#pragma unroll
  for (int i = 0; i < F::N; i++) r[i] = borrow ? s[i] : d[i];
}

template <class F>
__device__ __forceinline__ void add(uint32_t r[F::N], const uint32_t a[F::N], const uint32_t b[F::N]) {
  uint32_t s[F::N];
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < F::N; i++) {
    uint64_t t = (uint64_t)a[i] + b[i] + carry;
    s[i] = (uint32_t)t;
    carry = (uint32_t)(t >> 32);
  }
  reduce_once<F>(r, s);  // a + b < 2p < 2^(32N): no carry out
}

template <class F>
__device__ __forceinline__ void sub(uint32_t r[F::N], const uint32_t a[F::N], const uint32_t b[F::N]) {
  uint32_t d[F::N];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < F::N; i++) {
    uint64_t t = (uint64_t)a[i] - b[i] - borrow;
    d[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 32) & 1u;
  }
  // on borrow d = a - b + 2^(32N); adding p and dropping the carry gives a - b + p
  uint32_t carry = 0;
  const uint32_t mask = 0u - borrow;
#pragma unroll
  for (int i = 0; i < F::N; i++) {
    uint64_t t = (uint64_t)d[i] + (F::p(i) & mask) + carry;
    r[i] = (uint32_t)t;
    carry = (uint32_t)(t >> 32);
  }
}

template <class F>
__device__ __forceinline__ void neg(uint32_t r[F::N], const uint32_t a[F::N]) {
  uint32_t d[F::N];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < F::N; i++) {
    uint64_t t = (uint64_t)F::p(i) - a[i] - borrow;
    d[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 32) & 1u;
  }
  const bool z = is_zero<F>(a);
#pragma unroll
  for (int i = 0; i < F::N; i++) r[i] = z ? 0u : d[i];
}

// CIOS Montgomery product r = a b R^-1 mod p (Koc et al., "Analyzing and
// comparing Montgomery multiplication algorithms", 1996). Each word step
// adds a[j] b[i] (64-bit product) into t, then one m = t0 * (-p^-1) mod 2^32
// multiple of p shifts t down a word. t < 2p at the end.
template <class F>
__device__ __forceinline__ void mul(uint32_t r[F::N], const uint32_t a[F::N], const uint32_t b[F::N]) {
  constexpr int N = F::N;
  uint32_t t[N + 2];
#pragma unroll
  for (int i = 0; i < N + 2; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; j++) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * F::PINV;
    s = (uint64_t)m * F::p(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; j++) {
      s = (uint64_t)m * F::p(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  reduce_once<F>(r, t);  // t < 2p < 2^(32N), so t[N] == 0
}

// r = a^(p-2) = a^-1 (Montgomery in and out; 0 -> 0), left-to-right.
template <class F>
__device__ __forceinline__ void inverse(uint32_t r[F::N], const uint32_t a[F::N]) {
  uint32_t acc[F::N];
  set_one<F>(acc);
  for (int w = F::N - 1; w >= 0; w--) {
    const uint32_t e = F::pm2(w);
    for (int bit = 31; bit >= 0; bit--) {
      mul<F>(acc, acc, acc);
      if ((e >> bit) & 1u) mul<F>(acc, acc, a);
    }
  }
  copy<F>(r, acc);
}

// r = 12 a (b3 of y^2 = x^3 + 4) by additions.
template <class F>
__device__ __forceinline__ void mul12(uint32_t r[F::N], const uint32_t a[F::N]) {
  uint32_t a2[F::N], a4[F::N], a8[F::N];
  add<F>(a2, a, a);
  add<F>(a4, a2, a2);
  add<F>(a8, a4, a4);
  add<F>(r, a8, a4);
}

}  // namespace bpt
