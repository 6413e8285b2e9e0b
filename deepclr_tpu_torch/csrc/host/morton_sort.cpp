// Host Morton (Z-order) sort of point-cloud rows — the native fast path for
// the data pipeline's pad-time presort (deepclr_tpu_torch/data/batching.py);
// the port's own copy of native/morton_sort.cpp.
//
// Bit-identical to deepclr_tpu_torch.ops.morton.morton_argsort_np: the same
// double-precision cubic-cell quantization (10 bits/axis, shared metric
// scale) produces the same 30-bit keys, and the stable LSD radix sort
// yields the same permutation as numpy's stable argsort on those keys.
// The row gather happens here too, so python pays one call instead of a
// key build + argsort + fancy-index chain (measured 2.43 ms -> ~0.15 ms
// per 16k x 4 cloud).
//
// C ABI (ctypes): no pybind11 in this image.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint32_t expand_bits(uint32_t v) {
    v = (v | (v << 16)) & 0x030000FFu;
    v = (v | (v << 8)) & 0x0300F00Fu;
    v = (v | (v << 4)) & 0x030C30C3u;
    v = (v | (v << 2)) & 0x09249249u;
    return v;
}

}  // namespace

extern "C" {

// Sort the n rows of cloud (n x d float32, row-major; first 3 columns are
// xyz) by Morton code into out (n x d float32). cloud and out must not
// alias. Returns 0 on success, -1 on bad arguments.
long morton_sort_rows(const float* cloud, long n, long d, float* out) {
    if (!cloud || !out || n < 0 || d < 3) return -1;
    if (n == 0) return 0;
    if (n == 1) {
        std::memcpy(out, cloud, sizeof(float) * static_cast<size_t>(d));
        return 0;
    }

    const size_t un = static_cast<size_t>(n);
    const size_t ud = static_cast<size_t>(d);

    // Quantization identical to morton_argsort_np: double-precision
    // per-axis min, one shared metric scale (cubic cells), truncating
    // uint32 cast (values are clipped non-negative first).
    double lo[3], hi[3];
    for (int k = 0; k < 3; ++k) lo[k] = hi[k] = static_cast<double>(cloud[k]);
    for (size_t i = 1; i < un; ++i) {
        const float* row = cloud + i * ud;
        for (int k = 0; k < 3; ++k) {
            const double v = static_cast<double>(row[k]);
            if (v < lo[k]) lo[k] = v;
            if (v > hi[k]) hi[k] = v;
        }
    }
    double ext = 0.0;
    for (int k = 0; k < 3; ++k)
        if (hi[k] - lo[k] > ext) ext = hi[k] - lo[k];
    if (ext < 1e-6) ext = 1e-6;
    const double scale = 1023.0 / ext;

    std::vector<uint32_t> keys(un);
    for (size_t i = 0; i < un; ++i) {
        const float* row = cloud + i * ud;
        uint32_t q[3];
        for (int k = 0; k < 3; ++k) {
            double v = (static_cast<double>(row[k]) - lo[k]) * scale;
            if (v < 0.0) v = 0.0;
            if (v > 1023.0) v = 1023.0;
            q[k] = static_cast<uint32_t>(v);
        }
        keys[i] = (expand_bits(q[0]) << 2) | (expand_bits(q[1]) << 1) |
                  expand_bits(q[2]);
    }

    // Stable LSD radix sort of (key, index): 3 passes x 10 bits. Stability
    // makes the permutation equal to numpy's stable argsort of the keys.
    std::vector<uint32_t> idx(un), idx_tmp(un), keys_tmp(un);
    for (size_t i = 0; i < un; ++i) idx[i] = static_cast<uint32_t>(i);
    uint32_t count[1024];
    for (int shift = 0; shift < 30; shift += 10) {
        std::memset(count, 0, sizeof(count));
        for (size_t i = 0; i < un; ++i)
            ++count[(keys[i] >> shift) & 1023u];
        uint32_t sum = 0;
        for (int b = 0; b < 1024; ++b) {
            const uint32_t c = count[b];
            count[b] = sum;
            sum += c;
        }
        for (size_t i = 0; i < un; ++i) {
            const uint32_t pos = count[(keys[i] >> shift) & 1023u]++;
            keys_tmp[pos] = keys[i];
            idx_tmp[pos] = idx[i];
        }
        keys.swap(keys_tmp);
        idx.swap(idx_tmp);
    }

    for (size_t i = 0; i < un; ++i)
        std::memcpy(out + i * ud, cloud + static_cast<size_t>(idx[i]) * ud,
                    sizeof(float) * ud);
    return 0;
}

}  // extern "C"
