// The prologue's kernel parameters (prepare.cu), shared with graph_bind.cu,
// which points a captured prologue at a call's depth and normals.
#pragma once

namespace tpuao {

constexpr int kPrepareMaxLevels = 6;

// Output planes: z[0] is linz, z[l] depth level l; gx[l], gy[l] the slope
// planes of level l >= 1 (null without normals).
struct PrepareOut {
  float* z[kPrepareMaxLevels + 1];
  float* gx[kPrepareMaxLevels + 1];
  float* gy[kPrepareMaxLevels + 1];
};

struct PrepareArgs {
  const float* depth;  // (batch, h0, w0), rows dense, strides below
  const float* nrm;    // normals, element strides below, or null
  long long db, dh;    // depth's batch and row strides
  long long nb, nh, nw, nc;  // batch, row, column, channel strides
  int h0, w0, hp, wp, levels;
  int mode;   // 0: linear depth, 1: reversed-Z, 2: forward-Z
  float zm;   // float32((far - near) / near)
  float ts0;  // float32(2 tanH / wp)
  int vec_depth;  // depth rows allow 16-byte loads
  int vec_nrm;    // dense channel-last normals allowing 16-byte loads
};

// Whether `func` is an instance of prepare.cu's prologue kernel, whose
// parameters are a PrepareArgs and a PrepareOut.
bool is_prepare_kernel(const void* func);

}  // namespace tpuao
