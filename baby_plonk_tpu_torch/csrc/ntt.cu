// Sub-NTT: all log2(m) radix-2 butterfly stages of a length-m Fr NTT over
// columns held in shared memory, with the four-step transform's epilogue in
// the kernel. One kernel, launched twice per four-step transform, each
// element read once and written once per launch.
//
// Replaces: ntt_sub_pallas + _ntt_sub_kernel + _stage_twiddles
// (baby_plonk_tpu/ops/pallas_kernels.py:310-389), which ran the Pease stages
// of one (16, m, B) block resident in VMEM, and ntt_sub_pallas_4step
// (:392-432), which composed two of those with a bit-reversal gather, a
// cross-twiddle multiply and a transpose as separate passes over memory.
// The wrapper ops/kernels.py::ntt_sub keeps ntt_sub_pallas's contract
// (Montgomery in, rows out in BIT-REVERSED order, no 1/m scaling, batch axes
// K and B); ops/kernels.py::ntt_sub_4step launches this kernel twice.
//
// Bound on this card: the Montgomery multiplies (m/2 log2 m per column, 136
// 32-bit multiply-adds each) and one read and one write of 64 bytes an
// element per launch.
//
// Design.
//  * A column is addressed through strides (row stride, column stride, an
//    inner batch), so one kernel serves both passes: pass 1 transforms the
//    strided columns of the (m1, m2) matrix and stores row j1 in natural
//    order, multiplied by the cross twiddle w^(j1 i2) (1/n folded in for
//    the scaled inverse); pass 2 transforms that matrix's ROWS, which lie
//    contiguous in memory, and stores element j2 of row j1 at j2 m1 + j1:
//    the transpose is the store's index map, in runs of C contiguous
//    elements. No gather, no separate multiply, no transposed copy.
//  * A block owns C whole columns, C = 8 where there are 8: every global
//    load and store covers full 32-byte sectors of a limb plane.
//  * Shared memory is word-major and column-major: word w of row i of
//    column c lies at sh[w][c * S + phys(i)], S = m + 32 / C. In the
//    butterflies consecutive threads take consecutive butterflies of one
//    column, so a warp reads 32 consecutive words: no bank conflict. The
//    padding makes the column-fastest load and store phases conflict-free,
//    and phys(i) = i ^ (31 if bit 5 of i) spreads the stages whose half
//    length is under 32 (u and v interleave there) over all 32 banks.
//  * The stage twiddles are staged in shared memory once per block from a
//    table laid out stage by stage ((16, m - 1): stage of half length len
//    holds w^(off m / (2 len)), off < len, contiguous), so a warp's twiddle
//    reads are contiguous too.
//  * The block asks for its shared memory as dynamic shared memory above the
//    48 KB default (opted in once a device, up to 227 KB), so m C is not capped at
//    1024 elements: m = 1024 runs with C = 4.
//  * Gentleman-Sande decimation in frequency, in place: the rows end in
//    bit-reversed order in shared memory, and the store writes row r at
//    bitrev(r) (natural order) or at r (the bit-reversed contract): a row
//    permutation costs nothing on the way out.
#include "field.cuh"

using namespace bpt;

namespace {

struct SubNtt {
  const int32_t* in;
  int32_t* out;
  const int32_t* tw;     // (16, m - 1) stage twiddles
  const int32_t* cross;  // (16, m, cross_cols) or null
  int64_t limb_stride;   // elements between limb planes of in and out (K m ncols)
  int64_t ncols;         // columns per k
  int64_t inner;         // a column is (cq, cb) = (col / inner, col % inner)
  int64_t in_row, in_cq;    // element (k, i, cq, cb) of in at k m ncols + i in_row + cq in_cq + cb
  int64_t out_row, out_cq;  // the same for out, i the output row
  int64_t cross_cols, cross_div;  // cross twiddle of (row j, col) at j cross_cols + col / cross_div
  int m, logm, C, S;
  int natural;  // store row r at bitrev(r) (natural order) or at r
};

__device__ __forceinline__ int phys(int i, int m) {
  return m >= 64 ? i ^ (((i >> 5) & 1) * 31) : i;
}

__global__ void __launch_bounds__(512) ntt_sub_kernel(SubNtt p) {
  extern __shared__ uint32_t sh[];
  const int m = p.m, C = p.C, S = p.S;
  const int plane = C * S;          // words of one word plane of the data
  uint32_t* tws = sh + 8 * plane;   // [8][m - 1]
  const int ntw = m - 1;
  const int64_t col_blocks = p.ncols / C;
  const int64_t k = blockIdx.x / col_blocks;
  const int64_t col0 = (blockIdx.x % col_blocks) * C;
  const int64_t base = k * m * p.ncols;
  const int total = m * C;

  for (int e = threadIdx.x; e < ntw; e += blockDim.x) {
    uint32_t x[8];
    load<Fr>(x, p.tw + e, ntw);
#pragma unroll
    for (int w = 0; w < 8; w++) tws[w * ntw + e] = x[w];
  }
  // rows fastest where the rows lie contiguous in memory, else columns fastest
  const bool rows_fastest = p.in_row == 1;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int i = rows_fastest ? e % m : e / C;
    const int c = rows_fastest ? e / m : e % C;
    const int64_t col = col0 + c;
    uint32_t x[8];
    load<Fr>(x, p.in + base + (int64_t)i * p.in_row + (col / p.inner) * p.in_cq + col % p.inner,
             p.limb_stride);
    const int at = c * S + phys(i, m);
#pragma unroll
    for (int w = 0; w < 8; w++) sh[w * plane + at] = x[w];
  }
  __syncthreads();

  const int half = m / 2;
  const int butterflies = half * C;
  for (int len = half; len >= 1; len >>= 1) {
    const uint32_t* stage = tws + (m - 2 * len);  // this stage's twiddles: [len]
    for (int t = threadIdx.x; t < butterflies; t += blockDim.x) {
      const int c = t / half, j = t % half;
      const int off = j % len;
      const int i0 = (j / len) * 2 * len + off;
      const int a0 = c * S + phys(i0, m), a1 = c * S + phys(i0 + len, m);
      uint32_t u[8], v[8], w[8];
#pragma unroll
      for (int q = 0; q < 8; q++) {
        u[q] = sh[q * plane + a0];
        v[q] = sh[q * plane + a1];
        w[q] = stage[q * ntw + off];
      }
      uint32_t s[8];
      add<Fr>(s, u, v);
      sub<Fr>(u, u, v);
      mul<Fr>(u, u, w);
#pragma unroll
      for (int q = 0; q < 8; q++) {
        sh[q * plane + a0] = s[q];
        sh[q * plane + a1] = u[q];
      }
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = e / C, c = e % C;
    const int64_t col = col0 + c;
    const int j = (int)(__brev((unsigned)r) >> (32 - p.logm));  // the frequency that row r holds
    const int at = c * S + phys(r, m);
    uint32_t x[8];
#pragma unroll
    for (int w = 0; w < 8; w++) x[w] = sh[w * plane + at];
    if (p.cross != nullptr) {
      uint32_t cw[8];
      load<Fr>(cw, p.cross + (int64_t)j * p.cross_cols + col / p.cross_div,
               (int64_t)m * p.cross_cols);
      mul<Fr>(x, x, cw);
    }
    const int64_t row = p.natural ? j : r;
    store<Fr>(p.out + base + row * p.out_row + (col / p.inner) * p.out_cq + col % p.inner,
              p.limb_stride, x);
  }
}

}  // namespace

// Shared memory of one block, bytes: the data (8 word planes of C columns of
// S = m + 32 / C words) and the m - 1 staged twiddles.
extern "C" long long bpt_ntt_sub_smem(long long m, long long C) {
  const long long S = m + (C < 32 ? 32 / C : 1);
  return 8 * sizeof(uint32_t) * (C * S + (m - 1));
}

// One sub-NTT launch over K x ncols columns of length m (a power of two,
// >= 2); C columns a block, C dividing ncols. See SubNtt for the strides.
extern "C" int bpt_ntt_sub(const void* in, void* out, const void* tw, const void* cross,
                           long long K, long long m, long long ncols, long long inner,
                           long long in_row, long long in_cq, long long out_row, long long out_cq,
                           long long cross_cols, long long cross_div, long long C, int natural,
                           void* stream) {
  // The opt-in to more than 48 KB of shared memory holds for the device
  // that was current when it was made: one flag a device.
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    rc = cudaFuncSetAttribute(ntt_sub_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (rc != cudaSuccess) return (int)rc;
    opted_in[dev] = true;
  }
  SubNtt p;
  p.in = (const int32_t*)in;
  p.out = (int32_t*)out;
  p.tw = (const int32_t*)tw;
  p.cross = (const int32_t*)cross;
  p.limb_stride = K * m * ncols;
  p.ncols = ncols;
  p.inner = inner;
  p.in_row = in_row;
  p.in_cq = in_cq;
  p.out_row = out_row;
  p.out_cq = out_cq;
  p.cross_cols = cross_cols;
  p.cross_div = cross_div;
  p.m = (int)m;
  p.logm = 0;
  while ((1LL << p.logm) < m) p.logm++;
  p.C = (int)C;
  p.S = (int)(m + (C < 32 ? 32 / C : 1));
  p.natural = natural;
  const long long butterflies = m / 2 * C;
  const int threads = (int)(butterflies < 512 ? butterflies : 512);
  const size_t smem = (size_t)bpt_ntt_sub_smem(m, C);
  const long long blocks = K * (ncols / C);
  ntt_sub_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
