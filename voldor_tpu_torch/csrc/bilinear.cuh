// Texture-style bilinear sampling of a flow map, for sm_90a: the taps of
// voldor_tpu_torch/ops/image.py:bilinear_sample, shared by the kernels
// that walk a pixel through the window (chain_trace.cu, pose_collect.cu).
//
// The coordinate is clamped to the map (a NaN stays NaN, as torch.clamp
// keeps it), floored, a NaN floor indexed as 0 (image.py:_index), the
// right and bottom taps clamped to the last column and row, the four taps
// read as float2 through the read-only path, and the lerps taken in the
// plain version's order. Built with --fmad=false, so each product and sum
// rounds as torch's do.
#pragma once

#include <cuda_runtime.h>

namespace img {

// torch.clamp / torch.clamp_min: a NaN stays NaN
__device__ __forceinline__ float clamp_keep_nan(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float clamp_min_keep_nan(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

// image.bilinear_sample of an (h, w) float2 map at (x, y)
__device__ __forceinline__ float2 bilinear(const float2* __restrict__ map, float x, float y,
                                           int w, int h) {
  x = clamp_keep_nan(x, 0.0f, (float)(w - 1));
  y = clamp_keep_nan(y, 0.0f, (float)(h - 1));
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float fx = x - x0f;
  const float fy = y - y0f;
  const int x0 = x0f != x0f ? 0 : (int)x0f;
  const int y0 = y0f != y0f ? 0 : (int)y0f;
  const int x1 = min(x0 + 1, w - 1);
  const int y1 = min(y0 + 1, h - 1);
  const float2 v00 = __ldg(map + y0 * w + x0);
  const float2 v01 = __ldg(map + y0 * w + x1);
  const float2 v10 = __ldg(map + y1 * w + x0);
  const float2 v11 = __ldg(map + y1 * w + x1);
  const float gx = 1.0f - fx;
  const float gy = 1.0f - fy;
  const float top_x = v00.x * gx + v01.x * fx;
  const float top_y = v00.y * gx + v01.y * fx;
  const float bot_x = v10.x * gx + v11.x * fx;
  const float bot_y = v10.y * gx + v11.y * fx;
  return make_float2(top_x * gy + bot_x * fy, top_y * gy + bot_y * fy);
}

}  // namespace img
