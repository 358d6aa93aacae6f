// Native host-side batch gather for the input pipeline (a copy of the JAX
// package's native/dataloader.cpp, kept with the port so that the port
// builds from its own sources).
//
// The reference leans on torch's C++ DataLoader worker pool (6 workers,
// train.py:155) to hide per-item HDF5 reads and float conversion.  Here the
// equivalent hot loop -- gathering B uint8 images (memmap) + captions by
// index into one contiguous batch buffer -- runs on short-lived C++ threads
// driven through ctypes, so the loader's Python thread spends its time in
// the host-to-device copy, not in numpy fancy-indexing.
//
// Images stay uint8 NHWC end to end (normalisation runs on the device), so
// this is a pure wide memcpy problem: each worker copies a contiguous
// H*W*3 block per sample.  Threads are spawned per call (one gather per
// training batch, ~ms of memcpy vs ~20us of thread spawn) -- no shared
// mutable state.  Indices are checked by the Python wrapper.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

void gather_range(const uint8_t* images, int64_t item_bytes,
                  const int32_t* captions, const int32_t* caplens,
                  int64_t cap_len, const int64_t* img_indices,
                  const int64_t* cap_indices, int64_t begin, int64_t end,
                  uint8_t* out_images, int32_t* out_captions,
                  int32_t* out_caplens) {
  for (int64_t i = begin; i < end; ++i) {
    std::memcpy(out_images + i * item_bytes,
                images + img_indices[i] * item_bytes,
                static_cast<size_t>(item_bytes));
    std::memcpy(out_captions + i * cap_len, captions + cap_indices[i] * cap_len,
                static_cast<size_t>(cap_len) * sizeof(int32_t));
    out_caplens[i] = caplens[cap_indices[i]];
  }
}

}  // namespace

extern "C" {

// Gather B samples: images[img_indices[i]] -> out_images[i],
// captions[cap_indices[i]] -> out_captions[i], caplens likewise.
// item_bytes = H*W*3; cap_len = caption row length (int32 elements).
void gather_batch(const uint8_t* images, int64_t item_bytes,
                  const int32_t* captions, const int32_t* caplens,
                  int64_t cap_len, const int64_t* img_indices,
                  const int64_t* cap_indices, int64_t batch,
                  uint8_t* out_images, int32_t* out_captions,
                  int32_t* out_caplens, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > batch) n_threads = static_cast<int>(batch);
  if (n_threads == 1) {
    gather_range(images, item_bytes, captions, caplens, cap_len, img_indices,
                 cap_indices, 0, batch, out_images, out_captions, out_caplens);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  const int64_t chunk = (batch + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t begin = t * chunk;
    const int64_t end = begin + chunk < batch ? begin + chunk : batch;
    if (begin >= end) break;
    workers.emplace_back(gather_range, images, item_bytes, captions, caplens,
                         cap_len, img_indices, cap_indices, begin, end,
                         out_images, out_captions, out_caplens);
  }
  for (auto& w : workers) w.join();
}

}  // extern "C"
