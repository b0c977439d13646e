// Per-row values of a batched launch (one row a chunk of a group), passed by
// value in the launch's parameters: the wrapper checks them on the host, and
// no copy precedes the launch.  A kernel indexes them by its row; the loads
// come from the constant bank.  kMaxRows is the config's largest batch
// (device.batch_chunks <= 16).
//
// A kernel whose blocks walk a row (K1, K3) takes a flat grid cut into
// consecutive runs of blocks, one run a row, sized on the host by the row's
// work (block_runs), so that a short row takes few blocks and a long one
// many: a rectangular grid would give every row the longest row's count.
//
// Included by several sources: everything here has internal linkage.

#pragma once

#include <stdint.h>

namespace {

constexpr int kMaxRows = 16;

struct RowValues {
  int64_t v[kMaxRows + 1];  // count <= kMaxRows + 1 used (offsets take rows + 1)
};

// The first `count` entries of a host array as launch parameters.
inline RowValues row_values(const int64_t* host, int count) {
  RowValues r = {};
  for (int i = 0; i < count && i <= kMaxRows; ++i) r.v[i] = host[i];
  return r;
}

// Share out about `total` blocks among `rows` rows that can each use at
// most need[r] blocks, in proportion to need, at least one a row that needs
// any: the offsets of the runs in off[0 .. rows] (off[rows] is the grid's
// size).
inline RowValues block_runs(const int64_t* need, int rows, int64_t total) {
  int64_t sum = 0;
  for (int r = 0; r < rows; ++r) sum += need[r];
  RowValues off = {};
  for (int r = 0; r < rows; ++r) {
    int64_t b = sum > 0 ? (need[r] * total + sum - 1) / sum : 0;  // ceil of the row's share
    b = b < need[r] ? b : need[r];
    off.v[r + 1] = off.v[r] + b;
  }
  return off;
}

// The row whose run holds flat block `block`.
__device__ __forceinline__ int row_of_block(const RowValues& runs, int64_t block) {
  int row = 0;
  while (block >= runs.v[row + 1]) ++row;
  return row;
}

}  // namespace
