// Split TF32: an f32 value as the sum of two TF32 values, so that tensor
// cores, whose TF32 operands keep 11 significant bits, can multiply f32
// operands to about f32 accuracy (CUTLASS's 3xTF32). Each f32 operand v is
// split into big = cvt.rna.tf32(v) and small = cvt.rna.tf32(v - big), and a
// product of two f32 operands is taken as three TF32 products,
//   a * b = as * bb + ab * bs + ab * bb   (as * bs, about 2^-22 of |a b|, dropped)
// summed in f32, the small terms first. Shared by grouped_matmul.cu (K7's
// "tf32" variant) and flash_attention.cu (K8's "tf32" variant).
#pragma once

#include <cstdint>

namespace tf32 {

// v rounded to TF32, to nearest with ties away from zero, in f32's layout
// (the 13 low bits of the mantissa cleared).
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t out;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(out) : "f"(v));
  return out & 0xffffe000u;
}

// (big, small) of v: big = tf32(v), small = tf32(v - big); a 16-bit value is
// its own big part (exact in TF32) and has no small one.
template <bool kSplit>
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  if constexpr (kSplit) {
    big = to_tf32(v);
    small = to_tf32(v - __uint_as_float(big));
  } else {
    big = __float_as_uint(v);
    small = 0u;
  }
}

}  // namespace tf32
