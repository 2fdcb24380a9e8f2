// Launch-size helpers shared by the port's kernel sources.
#pragma once

#include <atomic>

#include <cuda_runtime.h>

namespace ngs {

// The current device's SM count, read from the CUDA runtime once per device: a
// launcher calls this on every launch.
inline int sm_count() {
    constexpr int kDevices = 64;
    static std::atomic<int> counts[kDevices];  // 0: not asked yet
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 1;  // the launch that follows reports it
    const bool cached = dev >= 0 && dev < kDevices;
    if (cached) {
        const int n = counts[dev].load(std::memory_order_relaxed);
        if (n > 0) return n;
    }
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
        return 1;
    if (cached) counts[dev].store(n, std::memory_order_relaxed);
    return n;
}

}  // namespace ngs
