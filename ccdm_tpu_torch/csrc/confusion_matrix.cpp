// Confusion counts for Cityscapes-style scoring on the host (the port of
// ccdm_tpu/native/confusion_matrix.cpp, with the same three functions and
// semantics). Built with the host's C++ compiler at first use and bound with
// ctypes by ccdm_tpu_torch/native.py, which checks every size and range
// before a pointer reaches these loops.

#include <cstdint>

extern "C" {

// cm is a [n_ids * n_ids] row-major int64 matrix indexed [gt, pred].
void add_to_confusion_matrix(const uint8_t* gt, const uint8_t* pred, int64_t n_pixels,
                             int64_t n_ids, int64_t* cm) {
    for (int64_t i = 0; i < n_pixels; ++i) {
        ++cm[static_cast<int64_t>(gt[i]) * n_ids + pred[i]];
    }
}

// The same, for int32 class maps.
void add_to_confusion_matrix_i32(const int32_t* gt, const int32_t* pred, int64_t n_pixels,
                                 int64_t n_ids, int64_t* cm) {
    for (int64_t i = 0; i < n_pixels; ++i) {
        ++cm[static_cast<int64_t>(gt[i]) * n_ids + pred[i]];
    }
}

// Per pair of class maps, per class, the intersection and union counts.
// x: [sx, p] uint8, y: [sy, p]; out_inter and out_union: [sx * sy * n_classes]
// int64, zeroed by the caller, indexed [ix, iy, c].
void pairwise_intersection_union(const uint8_t* x, const uint8_t* y, int64_t sx, int64_t sy,
                                 int64_t p, int64_t n_classes, int64_t* out_inter,
                                 int64_t* out_union) {
    for (int64_t ix = 0; ix < sx; ++ix) {
        for (int64_t iy = 0; iy < sy; ++iy) {
            int64_t* inter = out_inter + (ix * sy + iy) * n_classes;
            int64_t* uni = out_union + (ix * sy + iy) * n_classes;
            const uint8_t* xr = x + ix * p;
            const uint8_t* yr = y + iy * p;
            for (int64_t i = 0; i < p; ++i) {
                const uint8_t a = xr[i];
                const uint8_t b = yr[i];
                ++uni[a];
                if (a == b) {
                    ++inter[a];
                } else {
                    ++uni[b];
                }
            }
        }
    }
}

}  // extern "C"
