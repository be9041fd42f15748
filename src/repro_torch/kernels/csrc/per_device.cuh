// One value a CUDA device, for host code that records per-device state.
//
// A kernel's dynamic shared-memory opt-in (cudaFuncSetAttribute) acts on
// the current device's context, so a process that launches a kernel on
// several cards must grant it once on each.  Every opt-in of the port's
// kernels keeps its record in a static PerDevice (one per kernel template
// instantiation) and reads the slot of the device current on the calling
// thread, which the Python wrappers set to their input's device.
#pragma once

#include <cuda_runtime.h>

template <typename T = bool>
struct PerDevice {
  static constexpr int kDevices = 64;
  T on[kDevices] = {};
  T spare = {};  // a device ordinal past kDevices: no record, ask again
  __host__ T& here() {
    int d = 0;
    cudaGetDevice(&d);
    if (d < 0 || d >= kDevices) {
      spare = T{};
      return spare;
    }
    return on[d];
  }
};
