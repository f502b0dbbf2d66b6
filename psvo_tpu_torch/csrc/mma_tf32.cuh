// TF32 tensor-core products in float32 accuracy ("3xTF32"): each float32
// operand is split as a = hi + lo with hi = tf32(a) (cvt.rna: round to
// nearest, ties away, to 10 mantissa bits) and lo = tf32(a − hi), and a·b is
// taken as hi·hi + hi·lo + lo·hi on mma.sync m16n8k8 with float32
// accumulators. The dropped lo·lo term and the roundings leave a few 1e-7
// relative, against about 3e-4 for a single TF32 pass.
//
// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, per lane
// with g = lane >> 2 and t = lane & 3: A (16×8, row) a0 = A[g][t], a1 =
// A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]; B (8×8, col) b0 = B[t][g],
// b1 = B[t+4][g]; C and D (16×8) c0 = D[g][2t], c1 = D[g][2t+1], c2 =
// D[g+8][2t], c3 = D[g+8][2t+1]. Which rows of A and which entries of the
// sum a lane's registers stand for is the caller's choice, as long as A, B
// and D agree: K10 pairs them so that each pair is one 8-byte load.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace psvo {

// tf32(x) rounded to nearest, ties away from zero: the bits of
// cvt.rna.tf32.f32 for finite x, in two integer instructions (nvcc lowers
// cvt.rna to five, with a test for infinities).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// d += A·B for one m16n8k8 tile.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo: hi = tf32(x) rounded to nearest (ties away), lo = x − hi as a
// float32 bit pattern, whose 13 low bits the tensor core drops (lo rounded
// toward zero to TF32: at most 2^-21 of |x| lost, one instruction saved).
struct Tf32Split {
  uint32_t hi, lo;
};
__device__ __forceinline__ Tf32Split split_tf32(float x) {
  const uint32_t hi = tf32_rna(x);
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}

// One m16n8k8 step of a 3xTF32 product from float32 fragments: big += hi·hi,
// small += hi·lo + lo·hi (separate accumulators: more independent chains).
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&small)[4],
                                           const float (&a)[4], Tf32Split b0, Tf32Split b1) {
  uint32_t ah[4], al[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const Tf32Split s = split_tf32(a[e]);
    ah[e] = s.hi;
    al[e] = s.lo;
  }
  mma_tf32(small, al, b0.hi, b1.hi);
  mma_tf32(small, ah, b0.lo, b1.lo);
  mma_tf32(big, ah, b0.hi, b1.hi);
}

}  // namespace psvo
