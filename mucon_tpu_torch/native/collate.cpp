// Native batch-collate kernel: pad-copy per-video arrays into the batch.
//
// Collating a padded batch is dominated by the feature memcpy
// (B x Tpad x D x 4 bytes — ~134 MB at the bench shape), which in numpy
// holds the GIL on the prefetch thread and stalls the training loop's
// Python dispatch.  This kernel does all per-video copies in one ctypes
// call (ctypes releases the GIL for the duration), so host batch prep
// truly overlaps device compute.  The reference gets the same effect from
// torch DataLoader worker processes (trainers.py:97-105); here a thread +
// GIL-free copy replaces the process pool.
//
// The port's own copy of mucon_tpu/native/collate.cpp.
//
// Build: g++ -O3 -shared -fPIC (see mucon_tpu_torch/native/__init__.py).
// Interface: plain C ABI consumed via ctypes — no pybind11 dependency.

#include <cstdint>
#include <cstring>

extern "C" {

// dst [B x Tpad x D] float32, zero-initialized by the caller; srcs[i] is
// video i's [lens[i] x D] float32 features.
void pad_copy_f32(float* dst, const float** srcs, const int64_t* lens,
                  int64_t B, int64_t Tpad, int64_t D) {
  for (int64_t b = 0; b < B; ++b) {
    std::memcpy(dst + b * Tpad * D, srcs[b],
                static_cast<size_t>(lens[b]) * D * sizeof(float));
  }
}

// dst [B x Tpad] int32 zero-initialized; srcs[i] is [lens[i]] int64 labels.
void pad_copy_i64_to_i32(int32_t* dst, const int64_t** srcs,
                         const int64_t* lens, int64_t B, int64_t Tpad) {
  for (int64_t b = 0; b < B; ++b) {
    const int64_t* s = srcs[b];
    int32_t* d = dst + b * Tpad;
    for (int64_t t = 0; t < lens[b]; ++t) d[t] = static_cast<int32_t>(s[t]);
  }
}

}  // extern "C"
