// The offset table of K1's kernels past width 512 (fused_mlp_wide1k_tc.cu,
// bf16, and fused_mlp_wide1k_f32tc.cu, f32): trunk or view widths from 513 up
// to kWide1kMaxWidth, at most kWideMaxDepth dense layers. The table is the
// wide kernels' (fused_mlp_wide.cuh: the same order, 32 layer slots, the
// same WideLayout); only the widest ld differs. kWideMaxWidth stays the
// width the <= 512 kernels lay out their shared memory for.

#pragma once

#include "fused_mlp_wide.cuh"

namespace nerf {
namespace wide1k {

using wide::kWideLayoutLen;
using wide::kWideMaxDepth;
using wide::WideLayout;

constexpr int kWide1kMaxWidth = 1024;

// parse_wide_layout's checks with widths up to kWide1kMaxWidth.
inline bool parse_wide1k_layout(const long long* layout, int layout_len, int ldw, int ldv,
                                int depth, WideLayout* L) {
  constexpr int D = kWideMaxDepth;
  if (layout_len != kWideLayoutLen || depth < 1 || depth > D || ldw < 8 ||
      ldw > kWide1kMaxWidth || ldw % 8 != 0 || ldv < 8 || ldv > kWide1kMaxWidth ||
      ldv % 8 != 0) {
    return false;
  }
  // parse_wide_layout checks the offsets the same way; it takes widths up
  // to kWideMaxWidth, so it reads the table at ld 8 and the widths are set
  // after.
  if (!wide::parse_wide_layout(layout, layout_len, 8, 8, depth, L)) return false;
  L->ldw = ldw;
  L->ldv = ldv;
  return true;
}

}  // namespace wide1k
}  // namespace nerf
