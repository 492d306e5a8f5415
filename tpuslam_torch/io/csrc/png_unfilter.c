/* PNG row unfiltering (PNG 1.2 spec, section 6), the compiled helper of
 * tpuslam_torch/io/png.py.  png.py's numpy version is the plain one and
 * handles Sub and Up rows itself; this file runs every row in C, for
 * images whose rows are Avg- or Paeth-filtered (one byte at a time in
 * Python otherwise).
 *
 * in:  h rows of (1 + stride) bytes, each a filter type then the filtered row
 * out: h rows of stride bytes, the reconstructed samples
 * bpp: bytes per complete pixel (the left neighbour's distance)
 * Returns 0, or 1 + the index of the first row with an unknown filter type.
 */
#include <stdint.h>
#include <stdlib.h>

int png_unfilter(const uint8_t* in, uint8_t* out, int h, int stride, int bpp) {
  for (int y = 0; y < h; y++) {
    const uint8_t* f = in + (size_t)y * (stride + 1);
    const uint8_t* row = f + 1;
    uint8_t* cur = out + (size_t)y * stride;
    const uint8_t* prev = y > 0 ? out + (size_t)(y - 1) * stride : NULL;
    switch (f[0]) {
      case 0:
        for (int x = 0; x < stride; x++) cur[x] = row[x];
        break;
      case 1:
        for (int x = 0; x < stride; x++) cur[x] = (uint8_t)(row[x] + (x >= bpp ? cur[x - bpp] : 0));
        break;
      case 2:
        for (int x = 0; x < stride; x++) cur[x] = (uint8_t)(row[x] + (prev ? prev[x] : 0));
        break;
      case 3:
        for (int x = 0; x < stride; x++) {
          int a = x >= bpp ? cur[x - bpp] : 0, b = prev ? prev[x] : 0;
          cur[x] = (uint8_t)(row[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int x = 0; x < stride; x++) {
          int a = x >= bpp ? cur[x - bpp] : 0, b = prev ? prev[x] : 0;
          int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
          int p = a + b - c, pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[x] = (uint8_t)(row[x] + pred);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}
