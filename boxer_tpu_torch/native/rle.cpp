// Native COCO RLE codec + mask IoU.
//
// C++ fast path for boxer_tpu/utils/rle.py (used by segmentation eval where
// per-detection mask encoding dominates host time). Same contract as the
// numpy implementation (column-major runs, LEB128-style ascii compression).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// mask: (h, w) uint8 row-major. counts_out must hold h*w+1 entries.
// Returns number of counts (column-major runs starting with a 0-run).
int64_t mask_to_rle_counts(const uint8_t* mask, int64_t h, int64_t w,
                           uint32_t* counts_out) {
  int64_t n = 0;
  uint8_t cur = 0;
  uint32_t run = 0;
  for (int64_t x = 0; x < w; ++x) {
    for (int64_t y = 0; y < h; ++y) {
      uint8_t v = mask[y * w + x] ? 1 : 0;
      if (v == cur) {
        ++run;
      } else {
        counts_out[n++] = run;
        cur = v;
        run = 1;
      }
    }
  }
  counts_out[n++] = run;
  return n;
}

// Decode counts into a row-major uint8 mask buffer (h*w), zero-initialized
// by the caller.
void rle_counts_to_mask(const uint32_t* counts, int64_t n_counts,
                        int64_t h, int64_t w, uint8_t* mask_out) {
  int64_t pos = 0;
  uint8_t val = 0;
  for (int64_t i = 0; i < n_counts; ++i) {
    uint32_t c = counts[i];
    if (val) {
      for (uint32_t k = 0; k < c; ++k) {
        int64_t p = pos + k;
        mask_out[(p % h) * w + (p / h)] = 1;
      }
    }
    pos += c;
    val ^= 1;
  }
}

}  // extern "C"
