// DeviceScope, shared by the C entries of rope.cu and the norm kernels
// (norm_rows.cuh): binds the pointers' device for a launch.
#pragma once

#include <cuda_runtime.h>

namespace {

// Makes `device` current for the launch and puts the caller's device back
// after it, calling cudaSetDevice only when they differ (autograd's device
// thread may start with no current device of its own).
struct DeviceScope {
  int prev = -1, want = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceScope(int device) : want(device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != want) err = cudaSetDevice(want);
  }
  ~DeviceScope() {
    if (prev >= 0 && prev != want) cudaSetDevice(prev);
  }
};

}  // namespace
