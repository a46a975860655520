// Pieces shared by the two path-DP kernels (path_dp.cu, a warp a lane
// for cap > 32; path_dp_warp.cu, a warp's lane group a lane for cap <=
// 32): the codon score, the empty-key sentinel and the blocked emission
// of one finished path.

#pragma once

#include <stdint.h>

namespace path_dp {

constexpr int kBigKey = 0x7FFFFFFF;

__device__ __forceinline__ float codon_score(int h) {
  return h == 0 ? 3.0f : 2.0f - 0.5f * (float)h;
}

// Writes one emitted path to slot `slot` of lane g in the slot-major
// cols [n_cols, block_w, G] (5 columns with compact5, else 7).
__device__ __forceinline__ void write_path(int* cols, int slot, int g, int G,
                                           int block_w, int compact5,
                                           unsigned start, unsigned end,
                                           unsigned hamv, unsigned rhs,
                                           unsigned rhe, int e_sp,
                                           int score_bits) {
  const long long stride = (long long)block_w * G;
  int* out = cols + (long long)slot * G + g;
  if (compact5) {
    out[0] = (int)(((unsigned)g << 16) | (start & 0xFFFFu));
    out[stride] = (int)(((end & 0xFFFFu) << 16) | rhs);
    out[2 * stride] = (int)((rhe << 16) | (hamv & 0xFFFFu));
    out[3 * stride] = e_sp;
    out[4 * stride] = score_bits;
  } else {
    out[0] = g;
    out[stride] = e_sp;
    out[2 * stride] = (int)start;
    out[3 * stride] = (int)end;
    out[4 * stride] = score_bits;
    out[5 * stride] = (int)((hamv << 16) | rhs);
    out[6 * stride] = (int)rhe;
  }
}

// Marks slot `slot` of lane g valid or, past the lane's count, empty
// (every column 0).
__device__ __forceinline__ void finish_slot(int* cols, unsigned char* valid,
                                            int slot, int g, int G,
                                            int block_w, int compact5,
                                            int cnt) {
  const long long o = (long long)slot * G + g;
  valid[o] = slot < cnt;
  if (slot >= cnt) {
    const int n_cols = compact5 ? 5 : 7;
    for (int c = 0; c < n_cols; ++c)
      cols[(long long)c * block_w * G + o] = 0;
  }
}

}  // namespace path_dp
