// PNG row unfiltering (RFC 2083 section 6) for `ccdm_tpu_torch/utils/png.py`:
// the Sub, Average and Paeth filters depend on the byte `bpp` to the left,
// so a row is a serial loop that NumPy cannot vectorise. Built for the host
// with the system C++ compiler at first use, loaded with ctypes.

#include <cstdint>
#include <cstdlib>

extern "C" {

// src: height rows of (1 filter byte + rowbytes bytes); dst: height x rowbytes.
// Returns 0, or 1 + the index of the first row whose filter type is not 0-4.
long long ccdm_png_unfilter(const uint8_t* src, uint8_t* dst, long long height,
                            long long rowbytes, int bpp) {
  for (long long r = 0; r < height; ++r) {
    const uint8_t* in = src + r * (rowbytes + 1);
    const uint8_t filter = in[0];
    ++in;
    uint8_t* out = dst + r * rowbytes;
    const uint8_t* up = r ? out - rowbytes : nullptr;
    switch (filter) {
      case 0:
        for (long long i = 0; i < rowbytes; ++i) out[i] = in[i];
        break;
      case 1:
        for (long long i = 0; i < rowbytes; ++i)
          out[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:
        for (long long i = 0; i < rowbytes; ++i)
          out[i] = static_cast<uint8_t>(in[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (long long i = 0; i < rowbytes; ++i) {
          const int left = i >= bpp ? out[i - bpp] : 0;
          const int above = up ? up[i] : 0;
          out[i] = static_cast<uint8_t>(in[i] + ((left + above) >> 1));
        }
        break;
      case 4:
        for (long long i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[i] = static_cast<uint8_t>(in[i] + pred);
        }
        break;
      default:
        return r + 1;
    }
  }
  return 0;
}

}  // extern "C"
