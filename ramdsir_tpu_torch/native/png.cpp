// PNG row unfiltering for the port's PNG decoder (data/png.py).
//
// A decoded PNG stream is `height` rows of one filter-type byte followed by
// `rowbytes` filtered bytes.  Filters Sub, Average and Paeth predict a byte
// from its reconstructed left neighbour (`bpp` bytes back), so the rows are
// rebuilt one byte after the other; numpy cannot vectorise that, and a Python
// loop over an 800 x 800 RGB image takes ~2M steps.  The plain numpy version
// (`data.png.unfilter_plain`) is kept for the tests, which hold this one to it.
//
// Built with g++ at first use (native/__init__.py) and bound with ctypes.
#include <cstdint>
#include <cstdlib>

extern "C" {

// Unfilter `height` rows of `src` (each 1 + rowbytes bytes) into `dst`
// (height * rowbytes bytes); bpp is the filter's byte distance, 1..8.
// Returns 0, or -(row + 1) for a row with an unknown filter type.
int64_t png_unfilter(const uint8_t* src, int64_t height, int64_t rowbytes, int bpp, uint8_t* dst) {
    const uint8_t* prev = nullptr;  // the previous reconstructed row, none for the first
    for (int64_t y = 0; y < height; ++y) {
        const uint8_t* in = src + y * (rowbytes + 1);
        const int type = in[0];
        ++in;
        uint8_t* out = dst + y * rowbytes;
        switch (type) {
            case 0:  // None
                for (int64_t x = 0; x < rowbytes; ++x) out[x] = in[x];
                break;
            case 1:  // Sub
                for (int64_t x = 0; x < rowbytes; ++x)
                    out[x] = static_cast<uint8_t>(in[x] + (x >= bpp ? out[x - bpp] : 0));
                break;
            case 2:  // Up
                for (int64_t x = 0; x < rowbytes; ++x)
                    out[x] = static_cast<uint8_t>(in[x] + (prev ? prev[x] : 0));
                break;
            case 3:  // Average
                for (int64_t x = 0; x < rowbytes; ++x) {
                    const int a = x >= bpp ? out[x - bpp] : 0;
                    const int b = prev ? prev[x] : 0;
                    out[x] = static_cast<uint8_t>(in[x] + ((a + b) >> 1));
                }
                break;
            case 4:  // Paeth
                for (int64_t x = 0; x < rowbytes; ++x) {
                    const int a = x >= bpp ? out[x - bpp] : 0;
                    const int b = prev ? prev[x] : 0;
                    const int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
                    const int p = a + b - c;
                    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
                    const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    out[x] = static_cast<uint8_t>(in[x] + pred);
                }
                break;
            default:
                return -(y + 1);
        }
        prev = out;
    }
    return 0;
}

}  // extern "C"
