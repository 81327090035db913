// Launch shapes of K1's two variants (csrc/gating.cu), shared with the
// no-op kernel of csrc/noop.cu, whose device time is the floor under K1's:
// both launch through these functions, so the floor always has K1's shape.
#pragma once

enum GatingVariant { kRowVariant = 0, kWarpVariant = 1 };

constexpr int kRowThreads = 128;    // row variant: one row per thread
constexpr int kWarpThreads = 256;   // warp variant: one row per warp

inline int gating_threads(int variant) {
  return variant == kRowVariant ? kRowThreads : kWarpThreads;
}

inline int gating_blocks(int T, int variant) {
  const int rows = variant == kRowVariant ? kRowThreads : kWarpThreads / 32;
  return (T + rows - 1) / rows;
}
