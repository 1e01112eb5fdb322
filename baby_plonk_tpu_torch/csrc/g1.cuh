// BLS12-381 G1 point formulas on the device: complete homogeneous-projective
// addition, doubling and mixed addition for y^2 = x^3 + 4 (a = 0, b3 = 12),
// Renes-Costello-Batina 2015 Algorithms 7, 9 and 8 — the formulas of
// baby_plonk_tpu/ops/g1_vec.py (padd :132, pdouble :165, padd_mixed :188),
// written with one Montgomery reduction per product. Every output coordinate
// is the same canonical Montgomery value as the JAX package's (its lazy
// wide-domain reduction computes the same residues).
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

// r = p + q (RCB15 Algorithm 7, a = 0); r may alias p or q.
static __device__ __noinline__ void g1_add(G1P& r, const G1P& p, const G1P& q) {
  uint32_t t0[12], t1[12], t2[12], t3[12], t4[12], t5[12], u[12], v[12];
  mul<Fq>(t0, p.x, q.x);
  mul<Fq>(t1, p.y, q.y);
  mul<Fq>(t2, p.z, q.z);
  add<Fq>(u, p.x, p.y);
  add<Fq>(v, q.x, q.y);
  mul<Fq>(t3, u, v);
  add<Fq>(u, t0, t1);
  sub<Fq>(t3, t3, u);  // X1 Y2 + X2 Y1
  add<Fq>(u, p.y, p.z);
  add<Fq>(v, q.y, q.z);
  mul<Fq>(t4, u, v);
  add<Fq>(u, t1, t2);
  sub<Fq>(t4, t4, u);  // Y1 Z2 + Y2 Z1
  add<Fq>(u, p.x, p.z);
  add<Fq>(v, q.x, q.z);
  mul<Fq>(t5, u, v);
  add<Fq>(u, t0, t2);
  sub<Fq>(t5, t5, u);  // X1 Z2 + X2 Z1
  add<Fq>(u, t0, t0);
  add<Fq>(t0, u, t0);  // 3 X1 X2
  mul12<Fq>(t2, t2);   // b3 Z1 Z2
  mul12<Fq>(t5, t5);   // b3 (X1 Z2 + X2 Z1)
  add<Fq>(u, t1, t2);  // z3t = t1 + b3 Z1 Z2
  sub<Fq>(t1, t1, t2); // t1m = t1 - b3 Z1 Z2
  uint32_t w0[12], w1[12];
  mul<Fq>(w0, t3, t1);
  mul<Fq>(w1, t4, t5);
  sub<Fq>(r.x, w0, w1);  // X3 = t3 t1m - t4 y3t
  mul<Fq>(w0, t5, t0);
  mul<Fq>(w1, t1, u);
  add<Fq>(r.y, w0, w1);  // Y3 = y3t 3t0 + t1m z3t
  mul<Fq>(w0, u, t4);
  mul<Fq>(w1, t0, t3);
  add<Fq>(r.z, w0, w1);  // Z3 = z3t t4 + 3t0 t3
}

// r = 2 p (RCB15 Algorithm 9, a = 0); r may alias p.
static __device__ __noinline__ void g1_double(G1P& r, const G1P& p) {
  uint32_t t0[12], t1[12], t2[12], z3[12], xy[12], y3p[12], u[12], w0[12], w1[12];
  mul<Fq>(t0, p.y, p.y);  // Y^2
  mul<Fq>(t2, p.z, p.z);  // Z^2
  mul<Fq>(t1, p.y, p.z);  // Y Z
  mul<Fq>(xy, p.x, p.y);  // X Y
  add<Fq>(z3, t0, t0);
  add<Fq>(z3, z3, z3);
  add<Fq>(z3, z3, z3);    // 8 Y^2
  mul12<Fq>(t2, t2);      // b3 Z^2
  add<Fq>(y3p, t0, t2);
  add<Fq>(u, t2, t2);
  add<Fq>(u, u, t2);      // 3 b3 Z^2
  sub<Fq>(t0, t0, u);     // t0m = Y^2 - 3 b3 Z^2
  mul<Fq>(w0, t2, z3);
  mul<Fq>(w1, t0, y3p);
  add<Fq>(r.y, w0, w1);   // Y3 = t2 z3 + t0m y3p
  mul<Fq>(w0, t0, xy);
  add<Fq>(r.x, w0, w0);   // X3 = 2 t0m X Y
  mul<Fq>(r.z, t1, z3);   // Z3 = Y Z 8 Y^2
}

// r = p + (qx, qy) with q affine, not the identity (RCB15 Algorithm 8,
// a = 0); complete in p. r may alias p.
static __device__ __noinline__ void g1_add_mixed(G1P& r, const G1P& p, const uint32_t qx[12],
                                          const uint32_t qy[12]) {
  uint32_t t0[12], t1[12], t3[12], t4[12], t5[12], bz[12], u[12], v[12];
  mul<Fq>(t0, p.x, qx);
  mul<Fq>(t1, p.y, qy);
  add<Fq>(u, p.x, p.y);
  add<Fq>(v, qx, qy);
  mul<Fq>(t3, u, v);
  add<Fq>(u, t0, t1);
  sub<Fq>(t3, t3, u);   // X1 Y2 + X2 Y1
  mul<Fq>(t4, p.z, qy);
  add<Fq>(t4, t4, p.y); // Y1 + Y2 Z1
  mul<Fq>(t5, p.z, qx);
  add<Fq>(t5, t5, p.x); // X1 + X2 Z1
  mul12<Fq>(bz, p.z);   // b3 Z1
  add<Fq>(u, t0, t0);
  add<Fq>(t0, u, t0);   // 3 X1 X2
  mul12<Fq>(t5, t5);    // y3t
  add<Fq>(u, t1, bz);   // z3t
  sub<Fq>(t1, t1, bz);  // t1m
  uint32_t w0[12], w1[12];
  mul<Fq>(w0, t3, t1);
  mul<Fq>(w1, t4, t5);
  sub<Fq>(r.x, w0, w1);
  mul<Fq>(w0, t5, t0);
  mul<Fq>(w1, t1, u);
  add<Fq>(r.y, w0, w1);
  mul<Fq>(w0, u, t4);
  mul<Fq>(w1, t0, t3);
  add<Fq>(r.z, w0, w1);
}

}  // namespace bpt
