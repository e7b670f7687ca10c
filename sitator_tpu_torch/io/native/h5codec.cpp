// h5codec — the native codecs of HDF5 chunks: byte shuffle, LZF, the
// Fletcher-32 checksum and scale-offset.
//
// These are the filters h5py writes besides deflate (which is a zlib stream,
// decoded by Python's zlib): HDF5's shuffle filter (id 2), h5py's LZF
// filter (id 32000, raw LZF without a header), HDF5's Fletcher-32 filter
// (id 3) and HDF5's scale-offset filter (id 6, integer and floating-point
// D-scale).  Each call decodes one chunk; the reader runs chunks on a pool
// of threads (ctypes lets go of the interpreter).  C ABI, consumed via
// ctypes:
//
//   h5c_unshuffle:   undo the byte shuffle of n bytes of elements of
//                    `typesize` bytes; a tail shorter than one element is
//                    copied as it is;
//   h5c_lzf_decode:  decode a raw LZF stream; the bytes written, or a
//                    negative status;
//   h5c_fletcher32:  HDF5's Fletcher-32 over 16-bit big-endian words (an
//                    odd last byte is the high byte of a last word);
//   h5c_scaleoffset_decode: decode one scale-offset chunk from the filter's
//                    client data (cd_values) and the chunk's own header.
//
// Never throws; malformed input returns a negative status.
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kOk = 0, kTruncated = -1, kCorrupt = -6, kSize = -5,
              kUnsupported = -3;

// scale-offset client data (H5Zscaleoffset.c's parameter slots)
enum { kScaleType = 0, kScaleFactor, kNelmts, kClass, kSize_, kSign, kOrder,
       kFillAvail, kFillValue };
constexpr uint32_t kClassInteger = 0, kClassFloat = 1, kFloatDScale = 0;
constexpr int kHeaderBytes = 21;   // minbits (4), minval size (1), minval (16)

uint64_t load_le(const uint8_t* p, int n) {
    uint64_t v = 0;
    for (int i = n - 1; i >= 0; --i) v = (v << 8) | p[i];
    return v;
}

void store_le(uint8_t* p, int n, uint64_t v) {
    for (int i = 0; i < n; ++i, v >>= 8) p[i] = static_cast<uint8_t>(v);
}

void swap_elements(uint8_t* p, int64_t n, int size) {
    for (int64_t i = 0; i < n; ++i, p += size)
        for (int a = 0, b = size - 1; a < b; ++a, --b) {
            uint8_t t = p[a];
            p[a] = p[b];
            p[b] = t;
        }
}

// the fill value the filter carries in cd_values[8...], little-endian
uint64_t fill_value(const uint32_t* cd, int ncd, int size) {
    uint8_t bytes[8] = {0};
    for (int i = 0; i < size && i < 8; ++i) {
        int slot = kFillValue + i / 4;
        if (slot < ncd)
            bytes[i] = static_cast<uint8_t>(cd[slot] >> (8 * (i % 4)));
    }
    return load_le(bytes, size);
}

template <class F, class I>
void float_postprocess(uint8_t* dst, int64_t n, uint64_t minval, int minbits,
                       bool fill, uint64_t fill_bits, int scale) {
    F min;
    std::memcpy(&min, &minval, sizeof(F));
    F fillv;
    std::memcpy(&fillv, &fill_bits, sizeof(F));
    const F divisor = static_cast<F>(std::pow(10.0, scale));
    const I marker = static_cast<I>((uint64_t{1} << minbits) - 1);
    for (int64_t i = 0; i < n; ++i) {
        I v;
        std::memcpy(&v, dst + i * sizeof(F), sizeof(F));
        F out = (fill && v == marker)
                    ? fillv : static_cast<F>(static_cast<F>(v) / divisor + min);
        std::memcpy(dst + i * sizeof(F), &out, sizeof(F));
    }
}

}  // namespace

extern "C" {

void h5c_unshuffle(const uint8_t* src, int64_t n, int typesize,
                   uint8_t* dst) {
    if (typesize <= 1 || n < typesize) {
        std::memmove(dst, src, static_cast<size_t>(n));
        return;
    }
    const int64_t count = n / typesize;
    for (int b = 0; b < typesize; ++b) {
        const uint8_t* s = src + b * count;
        uint8_t* d = dst + b;
        for (int64_t i = 0; i < count; ++i) d[i * typesize] = s[i];
    }
    const int64_t done = count * typesize;
    std::memcpy(dst + done, src + done, static_cast<size_t>(n - done));
}

int64_t h5c_lzf_decode(const uint8_t* src, int64_t slen, uint8_t* dst,
                       int64_t dlen) {
    const uint8_t* ip = src;
    const uint8_t* const in_end = src + slen;
    uint8_t* op = dst;
    uint8_t* const out_end = dst + dlen;
    while (ip < in_end) {
        unsigned ctrl = *ip++;
        if (ctrl < (1u << 5)) {              // a run of ctrl + 1 literals
            ++ctrl;
            if (op + ctrl > out_end) return kSize;
            if (ip + ctrl > in_end) return kTruncated;
            std::memcpy(op, ip, ctrl);
            op += ctrl;
            ip += ctrl;
        } else {                             // a back reference
            unsigned len = ctrl >> 5;
            if (len == 7) {
                if (ip >= in_end) return kTruncated;
                len += *ip++;
            }
            if (ip >= in_end) return kTruncated;
            const int64_t back = ((ctrl & 0x1f) << 8) + *ip++ + 1;
            len += 2;
            if (op + len > out_end) return kSize;
            if (op - dst < back) return kCorrupt;
            const uint8_t* ref = op - back;
            for (unsigned k = 0; k < len; ++k) *op++ = *ref++;
        }
    }
    return op - dst;
}

uint32_t h5c_fletcher32(const uint8_t* data, int64_t n) {
    uint32_t sum1 = 0, sum2 = 0;
    int64_t words = n / 2;
    while (words) {
        int64_t t = words > 360 ? 360 : words;
        words -= t;
        do {
            sum1 += (static_cast<uint32_t>(data[0]) << 8) | data[1];
            data += 2;
            sum2 += sum1;
        } while (--t);
        sum1 = (sum1 & 0xffff) + (sum1 >> 16);
        sum2 = (sum2 & 0xffff) + (sum2 >> 16);
    }
    if (n % 2) {
        sum1 += static_cast<uint32_t>(*data) << 8;
        sum2 += sum1;
        sum1 = (sum1 & 0xffff) + (sum1 >> 16);
        sum2 = (sum2 & 0xffff) + (sum2 >> 16);
    }
    sum1 = (sum1 & 0xffff) + (sum1 >> 16);
    sum2 = (sum2 & 0xffff) + (sum2 >> 16);
    return (sum2 << 16) | sum1;
}

// One chunk: `src` is the filter's output (its 21-byte header, then the
// values packed most significant bit first, `minbits` bits each); `dst`
// receives cd[kNelmts] elements of cd[kSize_] bytes in the dataset's byte
// order (cd[kOrder]: 0 little-endian, 1 big-endian).
int h5c_scaleoffset_decode(const uint8_t* src, int64_t slen, uint8_t* dst,
                           int64_t dlen, const uint32_t* cd, int ncd) {
    if (ncd < kFillValue) return kCorrupt;
    const int size = static_cast<int>(cd[kSize_]);
    const int64_t n = cd[kNelmts];
    if (size < 1 || size > 8 || n * size != dlen) return kSize;
    if (slen < kHeaderBytes) return kTruncated;
    const uint64_t minbits = load_le(src, 4);
    const int minval_size = src[4] < 8 ? src[4] : 8;
    const uint64_t minval = load_le(src + 5, minval_size);
    const bool big = cd[kOrder] == 1;
    const uint8_t* packed = src + kHeaderBytes;
    const int64_t avail = slen - kHeaderBytes;
    if (minbits > static_cast<uint64_t>(8 * size)) return kCorrupt;
    if (minbits == static_cast<uint64_t>(8 * size)) {  // stored whole
        if (avail < dlen) return kTruncated;
        std::memcpy(dst, packed, static_cast<size_t>(dlen));
        if (big) swap_elements(dst, n, size);
        return kOk;
    }
    if ((static_cast<int64_t>(minbits) * n + 7) / 8 > avail)
        return kTruncated;
    // unpack, most significant bit first, into little-endian elements
    uint64_t bitpos = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t v = 0;
        for (uint64_t k = 0; k < minbits; ++k, ++bitpos)
            v = (v << 1) | ((packed[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
        store_le(dst + i * size, size, v);
    }
    const bool fill = cd[kFillAvail] == 1;
    const uint64_t fill_bits = fill_value(cd, ncd, size);
    if (cd[kClass] == kClassInteger) {
        const uint64_t mask = size == 8 ? ~uint64_t{0}
                                        : (uint64_t{1} << (8 * size)) - 1;
        const uint64_t marker = (uint64_t{1} << minbits) - 1;
        for (int64_t i = 0; i < n; ++i) {
            uint64_t v = load_le(dst + i * size, size);
            v = (fill && v == marker) ? fill_bits : ((v + minval) & mask);
            store_le(dst + i * size, size, v);
        }
    } else if (cd[kClass] == kClassFloat && cd[kScaleType] == kFloatDScale) {
        const int scale = static_cast<int>(cd[kScaleFactor]);
        if (size == 4)
            float_postprocess<float, int32_t>(dst, n, minval,
                                              static_cast<int>(minbits),
                                              fill, fill_bits, scale);
        else if (size == 8)
            float_postprocess<double, int64_t>(dst, n, minval,
                                               static_cast<int>(minbits),
                                               fill, fill_bits, scale);
        else
            return kUnsupported;
    } else {
        return kUnsupported;
    }
    if (big) swap_elements(dst, n, size);
    return kOk;
}

}  // extern "C"
