// Launch-size helpers shared by the port's kernel sources.
#pragma once

#include <cuda_runtime.h>

namespace ngs {

inline int sm_count() {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        n < 1)
        n = 1;  // the launch that follows reports the error
    return n;
}

}  // namespace ngs
