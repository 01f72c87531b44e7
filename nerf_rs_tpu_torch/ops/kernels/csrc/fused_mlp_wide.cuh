// The wide kernels' offset table (K1: fused_mlp_wide_tc.cu, bf16, and
// fused_mlp_wide_f32.cu, f32; K2: fused_mlp_wide_bwd_bf16.cu and
// fused_mlp_wide_bwd_tc.cu): K1 and K2 for networks beyond the narrow
// kernels' kMaxWidth or kMaxDepth (fused_mlp_common.cuh), up to
// kWideMaxWidth columns and kWideMaxDepth dense layers.
//
// The table has fused_mlp_common.cuh's order with kWideMaxDepth layer
// slots (ops/kernels/fused_mlp.py::pack_params writes it for every pack
// beyond the narrow envelope):
//   [0, 32)  dense layer i's main segment, [32, 64) its encode segment
//   (-1 if not a skip layer), 64 alpha, 65 bottleneck, 66 viewdirs,
//   67 viewdirs' dir-encode part, 68 rgb, [69, 101) dense layer i's bias,
//   101 alpha bias, 102 bottleneck bias, 103 viewdirs bias, 104 rgb bias.
// The narrow kernels keep their own 57-entry table: a table of one length
// never reaches the other's kernels.

#pragma once

#include "fused_mlp_common.cuh"

namespace nerf {
namespace wide {

constexpr int kWideMaxDepth = 32;
constexpr int kWideMaxWidth = 512;
constexpr int kWideLayoutLen = 3 * kWideMaxDepth + 9;

struct WideLayout {
  long long w_dense[kWideMaxDepth];
  long long w_skip[kWideMaxDepth];
  long long w_alpha, w_bneck, w_view, w_view_dir, w_rgb;
  long long b_dense[kWideMaxDepth];
  long long b_alpha, b_bneck, b_view, b_rgb;
  int ldw, ldv, depth;
};

// False for a table, offsets or widths the wide kernels do not take: every
// segment a layer reads present, weight segments on 8-element boundaries
// (16-byte bulk copies in bf16, float4 loads in f32).
inline bool parse_wide_layout(const long long* layout, int layout_len, int ldw, int ldv,
                              int depth, WideLayout* L) {
  constexpr int D = kWideMaxDepth;
  if (layout_len != kWideLayoutLen || depth < 1 || depth > D || ldw < 8 ||
      ldw > kWideMaxWidth || ldw % 8 != 0 || ldv < 8 || ldv > kWideMaxWidth || ldv % 8 != 0) {
    return false;
  }
  for (int i = 0; i < 2 * D + 5; ++i) {
    const bool needed = i < depth || i >= 2 * D;
    if ((needed && layout[i] < 0) || (layout[i] >= 0 && layout[i] % 8 != 0)) return false;
  }
  for (int i = 0; i < D; ++i) {
    L->w_dense[i] = layout[i];
    L->w_skip[i] = layout[D + i];
    L->b_dense[i] = layout[2 * D + 5 + i];
  }
  L->w_alpha = layout[2 * D];
  L->w_bneck = layout[2 * D + 1];
  L->w_view = layout[2 * D + 2];
  L->w_view_dir = layout[2 * D + 3];
  L->w_rgb = layout[2 * D + 4];
  L->b_alpha = layout[3 * D + 5];
  L->b_bneck = layout[3 * D + 6];
  L->b_view = layout[3 * D + 7];
  L->b_rgb = layout[3 * D + 8];
  L->ldw = ldw;
  L->ldv = ldv;
  L->depth = depth;
  return true;
}

}  // namespace wide
}  // namespace nerf
