// The epilogue activations of the convolution and int8 kernels, in fp32,
// by the codes their wrappers pass (ops/kernels/conv_fused.py and
// int8.py; gelu is erf, as jax.nn.gelu(approximate=False)).
#pragma once

#include <math.h>

namespace epilogue_act {

enum Act { kNone = 0, kRelu, kRelu6, kSigmoid, kTanh, kGelu, kSilu };

__device__ __forceinline__ float apply_act(float v, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(v, 0.0f);
    case kRelu6:
      return fminf(fmaxf(v, 0.0f), 6.0f);
    case kSigmoid:
      return 1.0f / (1.0f + expf(-v));
    case kTanh:
      return tanhf(v);
    case kGelu:
      return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
    case kSilu:
      return v / (1.0f + expf(-v));
    default:
      return v;
  }
}

}  // namespace epilogue_act
