// The attention logit softcap of the reference's gqa_attention
// (src/repro/models/attention.py, _sdpa: scores = c tanh(scores / c) on
// the scaled float32 scores, before the mask and the softmax), shared by
// every attention kernel of the port.
//
// A kernel computes the raw product s = q . k (or, where q is pre-scaled,
// scale q . k) and works in its own units u (log2 e for a softmax in exp2
// units, 1 for one in natural units).  SoftCap maps s to the capped score
// in those units, c u tanh(scale s / c): `in` folds the scale into the
// argument of tanh and `out` the units into the cap, so the cap always
// sees the true scaled score, never one already converted to log2 units.
// It is applied before the mask, so a masked key still gets -inf and a
// probability of exactly 0 (capping after the mask would turn the mask's
// -inf into -c).  tanhf is CUDA's accurate one (a few ulp), not
// tanh.approx.f32, whose ~2^-11 relative error would break the float32
// kernels' accuracy contract.  A cap of 0 means none: `on` is false and
// the kernel keeps its uncapped arithmetic bit for bit.
#pragma once

#include <math.h>

struct SoftCap {
  float in;    // scale / c
  float out;   // c * units
  int on;

  __host__ __device__ static SoftCap make(float softcap, float scale,
                                          float units) {
    SoftCap c;
    c.on = softcap > 0.f;
    c.in = c.on ? scale / softcap : 0.f;
    c.out = c.on ? softcap * units : 0.f;
    return c;
  }

  // the capped score in the kernel's units, and tanh itself (the backward
  // needs 1 - tanh^2)
  __device__ __forceinline__ float operator()(float s) const {
    return out * tanhf(s * in);
  }
  __device__ __forceinline__ float operator()(float s, float& th) const {
    th = tanhf(s * in);
    return out * th;
  }
};
