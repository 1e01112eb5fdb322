// BLS12-381 G1 point formulas on the device: complete homogeneous-projective
// addition, doubling and mixed addition for y^2 = x^3 + 4 (a = 0, b3 = 12),
// Renes-Costello-Batina 2015 Algorithms 7, 9 and 8 — the formulas of
// baby_plonk_tpu/ops/g1_vec.py (padd :132, pdouble :165, padd_mixed :188),
// written with one Montgomery reduction per product. Every output coordinate
// is the same canonical Montgomery value as the JAX package's (its lazy
// wide-domain reduction computes the same residues).
//
// Bound on this card: the 8 to 12 Fq products of a formula on the integer
// pipe, and the registers a lane needs to hold its points. A formula that is
// called through a pointer keeps its points on the stack, where every operand
// word is a load. So the formulas are __forceinline__ and update their first
// operand in place: all indices are constants after unrolling and the points
// stay in registers. Each reads its operands' coordinates before it writes
// one. Sums that go straight into a product stay unreduced (add_lazy; the
// bound is stated at each use), every coordinate written is canonical.
//
// Point memory layout: three (24, n) int32 limb arrays X, Y, Z (Montgomery).
// The identity is (0 : 1 : 0); an affine table entry (0, 0) marks it.
#pragma once
#include "field.cuh"

namespace bpt {

struct G1P {
  uint32_t x[12], y[12], z[12];
};

__device__ __forceinline__ void g1_identity(G1P& p) {
  set_zero<Fq>(p.x);
  set_one<Fq>(p.y);
  set_zero<Fq>(p.z);
}

__device__ __forceinline__ void g1_load(G1P& p, const int32_t* X, const int32_t* Y,
                                        const int32_t* Z, int64_t i, int64_t stride) {
  load<Fq>(p.x, X + i, stride);
  load<Fq>(p.y, Y + i, stride);
  load<Fq>(p.z, Z + i, stride);
}

__device__ __forceinline__ void g1_store(int32_t* X, int32_t* Y, int32_t* Z, int64_t i,
                                         int64_t stride, const G1P& p) {
  store<Fq>(X + i, stride, p.x);
  store<Fq>(Y + i, stride, p.y);
  store<Fq>(Z + i, stride, p.z);
}

// A point in shared memory, word-major over ``stride`` slots (word w of X at
// sm[w * stride + i], then Y, then Z): a warp's accesses to consecutive slots
// fall on distinct banks.
__device__ __forceinline__ void g1_smem_put(uint32_t* sm, int stride, int i, const G1P& p) {
#pragma unroll
  for (int w = 0; w < 12; w++) {
    sm[w * stride + i] = p.x[w];
    sm[(12 + w) * stride + i] = p.y[w];
    sm[(24 + w) * stride + i] = p.z[w];
  }
}

__device__ __forceinline__ void g1_smem_get(G1P& p, const uint32_t* sm, int stride, int i) {
#pragma unroll
  for (int w = 0; w < 12; w++) {
    p.x[w] = sm[w * stride + i];
    p.y[w] = sm[(12 + w) * stride + i];
    p.z[w] = sm[(24 + w) * stride + i];
  }
}

// r = u v - (c0 + c1) for u = a0 + a1, v = b0 + b1: the sums stay unreduced,
// u, v < 2p and u v < 4 p^2 < R p, inside the product's bound.
__device__ __forceinline__ void g1_cross(uint32_t r[12], const uint32_t a0[12], const uint32_t a1[12],
                                         const uint32_t b0[12], const uint32_t b1[12],
                                         const uint32_t c0[12], const uint32_t c1[12]) {
  uint32_t u[12], v[12];
  add_lazy(u, a0, a1);
  add_lazy(v, b0, b1);
  mul<Fq>(r, u, v);
  add<Fq>(u, c0, c1);
  sub<Fq>(r, r, u);
}

// The common tail of both additions: from t0 = 3 X1 X2, t1m, z3t, t3, t4 and
// y3t to the sum's coordinates.
__device__ __forceinline__ void g1_add_tail(G1P& p, const uint32_t t0[12], const uint32_t t1m[12],
                                            const uint32_t z3t[12], const uint32_t t3[12],
                                            const uint32_t t4[12], const uint32_t y3t[12]) {
  uint32_t w0[12], w1[12];
  mul<Fq>(w0, t3, t1m);
  mul<Fq>(w1, t4, y3t);
  sub<Fq>(p.x, w0, w1);  // X3 = t3 t1m - t4 y3t
  mul<Fq>(w0, y3t, t0);
  mul<Fq>(w1, t1m, z3t);
  add<Fq>(p.y, w0, w1);  // Y3 = y3t 3t0 + t1m z3t
  mul<Fq>(w0, z3t, t4);
  mul<Fq>(w1, t0, t3);
  add<Fq>(p.z, w0, w1);  // Z3 = z3t t4 + 3t0 t3
}

// p += q (RCB15 Algorithm 7, a = 0).
__device__ __forceinline__ void g1_add(G1P& p, const G1P& q) {
  uint32_t t0[12], t1[12], t2[12], t3[12], t4[12], t5[12], u[12];
  mul<Fq>(t0, p.x, q.x);
  mul<Fq>(t1, p.y, q.y);
  mul<Fq>(t2, p.z, q.z);
  g1_cross(t3, p.x, p.y, q.x, q.y, t0, t1);  // X1 Y2 + X2 Y1
  g1_cross(t4, p.y, p.z, q.y, q.z, t1, t2);  // Y1 Z2 + Y2 Z1
  g1_cross(t5, p.x, p.z, q.x, q.z, t0, t2);  // X1 Z2 + X2 Z1
  add<Fq>(u, t0, t0);
  add<Fq>(t0, u, t0);   // 3 X1 X2
  mul12<Fq>(t2, t2);    // b3 Z1 Z2
  mul12<Fq>(t5, t5);    // y3t = b3 (X1 Z2 + X2 Z1)
  add<Fq>(u, t1, t2);   // z3t = t1 + b3 Z1 Z2
  sub<Fq>(t1, t1, t2);  // t1m = t1 - b3 Z1 Z2
  g1_add_tail(p, t0, t1, u, t3, t4, t5);
}

// p = 2 p (RCB15 Algorithm 9, a = 0).
__device__ __forceinline__ void g1_double(G1P& p) {
  uint32_t t0[12], t1[12], t2[12], z3[12], xy[12], y3p[12], u[12], w0[12], w1[12];
  sqr<Fq>(t0, p.y);       // Y^2
  sqr<Fq>(t2, p.z);       // Z^2
  mul<Fq>(t1, p.y, p.z);  // Y Z
  mul<Fq>(xy, p.x, p.y);  // X Y
  add_lazy(z3, t0, t0);
  add_lazy(z3, z3, z3);
  add_lazy(z3, z3, z3);   // 8 Y^2, unreduced: < 8p < 2^384, only ever the second
                          // operand of a product whose first is canonical (a b < 8 p^2 < R p)
  mul12<Fq>(t2, t2);      // b3 Z^2
  add<Fq>(y3p, t0, t2);
  add<Fq>(u, t2, t2);
  add<Fq>(u, u, t2);      // 3 b3 Z^2
  sub<Fq>(t0, t0, u);     // t0m = Y^2 - 3 b3 Z^2
  mul<Fq>(w0, t2, z3);
  mul<Fq>(w1, t0, y3p);
  add<Fq>(p.y, w0, w1);   // Y3 = t2 z3 + t0m y3p
  mul<Fq>(w0, t0, xy);
  add<Fq>(p.x, w0, w0);   // X3 = 2 t0m X Y
  mul<Fq>(p.z, t1, z3);   // Z3 = Y Z 8 Y^2
}

// p += (qx, qy) with q affine, not the identity (RCB15 Algorithm 8, a = 0);
// complete in p.
__device__ __forceinline__ void g1_add_mixed(G1P& p, const uint32_t qx[12], const uint32_t qy[12]) {
  uint32_t t0[12], t1[12], t3[12], t4[12], t5[12], bz[12], u[12];
  mul<Fq>(t0, p.x, qx);
  mul<Fq>(t1, p.y, qy);
  g1_cross(t3, p.x, p.y, qx, qy, t0, t1);  // X1 Y2 + X2 Y1
  mul<Fq>(t4, p.z, qy);
  add<Fq>(t4, t4, p.y);  // Y1 + Y2 Z1
  mul<Fq>(t5, p.z, qx);
  add<Fq>(t5, t5, p.x);  // X1 + X2 Z1
  mul12<Fq>(bz, p.z);    // b3 Z1
  add<Fq>(u, t0, t0);
  add<Fq>(t0, u, t0);    // 3 X1 X2
  mul12<Fq>(t5, t5);     // y3t
  add<Fq>(u, t1, bz);    // z3t
  sub<Fq>(t1, t1, bz);   // t1m
  g1_add_tail(p, t0, t1, u, t3, t4, t5);
}

// Halving tree in shared memory (sm: 36 words a thread of the block). Each
// unit of U consecutive threads (U a power of two) sums the points its
// threads hold in acc: level h = U/2, ..., 1 adds the point of thread u + h
// into thread u (u = threadIdx.x % U), the order of the plain halving loops,
// so thread u = 0 of the unit ends with the sum in acc, limb for limb. A
// thread with ``active`` false adds nothing; no active thread reads its slot
// when a unit is all active or all not. Every thread of the block calls it:
// it holds the barriers. ``tmp`` is scratch.
__device__ __forceinline__ void g1_smem_tree(G1P& acc, G1P& tmp, uint32_t* sm, int U, bool active) {
  const int tid = threadIdx.x, slots = blockDim.x, u = tid % U;
  g1_smem_put(sm, slots, tid, acc);
#pragma unroll 1
  for (int h = U >> 1; h >= 1; h >>= 1) {
    __syncthreads();
    if (active && u < h) {
      g1_smem_get(tmp, sm, slots, tid + h);
      g1_add(acc, tmp);
      g1_smem_put(sm, slots, tid, acc);
    }
  }
}

}  // namespace bpt
