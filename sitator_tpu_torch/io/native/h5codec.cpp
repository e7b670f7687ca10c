// h5codec — the native codecs of HDF5 chunks: byte shuffle, LZF, the
// Fletcher-32 checksum, scale-offset, n-bit and szip.
//
// These are the filters h5py writes besides deflate (which is a zlib stream,
// decoded by Python's zlib): HDF5's shuffle filter (id 2), h5py's LZF
// filter (id 32000, raw LZF without a header), HDF5's Fletcher-32 filter
// (id 3), HDF5's scale-offset filter (id 6, integer and floating-point
// D-scale), its n-bit filter (id 5, atomic integers and floats) and its
// szip filter (id 4: a 4-byte little-endian decoded size, then the CCSDS
// 121.0-B adaptive Rice stream libaec's SZ-compatible API writes, decoded
// here by hand; no libsz or libaec is loaded).  Each call decodes one chunk;
// the reader runs chunks on a pool of threads (ctypes lets go of the
// interpreter).  C ABI, consumed via ctypes:
//
//   h5c_unshuffle:   undo the byte shuffle of n bytes of elements of
//                    `typesize` bytes; a tail shorter than one element is
//                    copied as it is;
//   h5c_lzf_decode:  decode a raw LZF stream; the bytes written, or a
//                    negative status;
//   h5c_fletcher32:  HDF5's Fletcher-32 over 16-bit big-endian words (an
//                    odd last byte is the high byte of a last word);
//   h5c_scaleoffset_decode: decode one scale-offset chunk from the filter's
//                    client data (cd_values) and the chunk's own header;
//   h5c_nbit_decode: unpack one n-bit chunk (each element's `precision`
//                    significant bits, most significant first, packed
//                    without gaps) into elements of the stored size and
//                    byte order, the bits at their offset, the rest zero;
//   h5c_szip_decode: decode one szip chunk from the filter's client data
//                    (options mask, pixels per block, bits per pixel,
//                    pixels per scan line).
//
// Never throws; malformed input returns a negative status.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

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

// Bits of a buffer, most significant first.
struct Bits {
    const uint8_t* p;
    int64_t nbits, pos = 0;

    Bits(const uint8_t* data, int64_t n) : p(data), nbits(8 * n) {}

    bool has(int64_t k) const { return pos + k <= nbits; }

    // the next 57 or more bits at the top of a word (zeros past the end)
    uint64_t window() const {
        const int64_t byte = pos >> 3, nbytes = nbits >> 3;
        uint64_t w = 0;
        for (int i = 0; i < 8; ++i)
            w = (w << 8) | (byte + i < nbytes ? p[byte + i] : 0);
        return w << (pos & 7);
    }

    // k (1..56) bits; the caller checks has(k)
    uint64_t get(int k) {
        const uint64_t v = window() >> (64 - k);
        pos += k;
        return v;
    }

    // a fundamental sequence: the zeros before the next one; -1 at the end
    int64_t fs() {
        int64_t zeros = 0;
        for (;;) {
            if (pos >= nbits) return -1;
            const uint64_t w = window();
            const int64_t room = std::min<int64_t>(57, nbits - pos);
            const int lead = w ? __builtin_clzll(w) : 64;
            if (lead < room) {
                pos += lead + 1;
                return zeros + lead;
            }
            zeros += room;
            pos += room;
        }
    }
};

// libaec's szip options (the SZ_*_OPTION_MASK bits HDF5 stores)
constexpr uint32_t kSzMsb = 16, kSzNN = 32;
constexpr int kRos = 5;                 // zero blocks: to the segment's end

// One adaptive Rice stream (CCSDS 121.0-B, as libaec decodes it without
// AEC_DATA_SIGNED, AEC_RESTRICTED or AEC_PAD_RSI) into `n` samples of
// `nbps` bits: blocks of J samples, `rsi` blocks a reference sample
// interval; with preprocessing the first sample of an interval is a
// reference and the others are mapped prediction residuals, undone here.
int aec_decode(Bits& in, int nbps, int J, int rsi, bool pp, int64_t n,
               std::vector<uint32_t>& out) {
    const int id_len = nbps > 16 ? 5 : nbps > 8 ? 4 : 3;
    const uint32_t id_max = (1u << id_len) - 1;
    const int64_t rsi_len = int64_t(rsi) * J;
    const int64_t n_rsi = (n + rsi_len - 1) / rsi_len;
    out.assign(size_t(n_rsi * rsi_len), 0);
    for (int64_t r = 0; r < n_rsi; ++r) {
        uint32_t* const seg = out.data() + r * rsi_len;
        int64_t b = 0;                          // blocks done in this RSI
        while (b < rsi && r * rsi_len + b * J < n) {
            const int ref = pp && b == 0;
            uint32_t* s = seg + b * J;
            if (!in.has(id_len)) return kTruncated;
            const uint32_t id = uint32_t(in.get(id_len));
            if (id == 0) {                      // low entropy
                if (!in.has(1 + ref * nbps)) return kTruncated;
                const int second = int(in.get(1));
                if (ref) s[0] = uint32_t(in.get(nbps));
                if (second) {                   // second extension
                    for (int i = ref; i < J;) {
                        const int64_t m = in.fs();
                        if (m < 0) return kTruncated;
                        if (m > 90) return kCorrupt;
                        int sum = 0;
                        while ((sum + 1) * (sum + 2) / 2 <= m) ++sum;
                        const uint32_t d1 = uint32_t(m - sum * (sum + 1) / 2);
                        if (!(i & 1)) s[i++] = uint32_t(sum) - d1;
                        if (i < J) s[i++] = d1;
                    }
                    ++b;
                } else {                        // a run of zero blocks
                    const int64_t fs = in.fs();
                    if (fs < 0) return kTruncated;
                    int64_t z = fs + 1;
                    if (z == kRos)
                        z = std::min<int64_t>(rsi - b, 64 - b % 64);
                    else if (z > kRos)
                        --z;
                    if (b + z > rsi) return kCorrupt;
                    std::memset(s + ref, 0, size_t(z * J - ref) * 4);
                    b += z;
                }
            } else if (id == id_max) {          // uncompressed
                if (!in.has(int64_t(J) * nbps)) return kTruncated;
                for (int i = 0; i < J; ++i) s[i] = uint32_t(in.get(nbps));
                ++b;
            } else {                            // split samples, k = id - 1
                const int k = int(id) - 1;
                if (ref) {
                    if (!in.has(nbps)) return kTruncated;
                    s[0] = uint32_t(in.get(nbps));
                }
                for (int i = ref; i < J; ++i) {
                    const int64_t fs = in.fs();
                    if (fs < 0) return kTruncated;
                    if (fs >= (int64_t(1) << (32 - std::min(k, 31))))
                        return kCorrupt;
                    s[i] = uint32_t(fs) << k;
                }
                if (k) {
                    if (!in.has(int64_t(J - ref) * k)) return kTruncated;
                    for (int i = ref; i < J; ++i) s[i] |= uint32_t(in.get(k));
                }
                ++b;
            }
        }
        if (!pp) continue;
        // undo the unit-delay prediction and the residuals' mapping
        const uint32_t xmax = nbps == 32 ? ~0u : (1u << nbps) - 1;
        const uint32_t med = xmax / 2 + 1;
        uint32_t x = seg[0];
        for (int64_t i = 1; i < rsi_len; ++i) {
            const uint32_t d = seg[i];
            const uint32_t mask = (x & med) ? xmax : 0;
            const uint32_t theta = mask ^ x;    // the distance to the bound
            if ((d >> 1) + (d & 1) <= theta)
                x = (d & 1) ? x - (d >> 1) - 1 : x + (d >> 1);
            else
                x = mask ^ d;
            seg[i] = x & xmax;
        }
    }
    return kOk;
}

void put_samples(const std::vector<uint32_t>& v, int64_t n, int bytes,
                 bool msb, uint8_t* dst) {
    for (int64_t i = 0; i < n; ++i, dst += bytes)
        for (int j = 0; j < bytes; ++j)
            dst[msb ? bytes - 1 - j : j] = uint8_t(v[size_t(i)] >> (8 * j));
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

// One n-bit chunk.  cd (H5Znbit.c's parameters): [0] their count, [1] 1 if
// the data were stored as they are, [2] the elements in a chunk, [3] the
// class (1: atomic; arrays, compounds and no-op classes are refused), then
// the atomic type's size, byte order (0 little-, 1 big-endian), precision
// and bit offset.
int h5c_nbit_decode(const uint8_t* src, int64_t slen, uint8_t* dst,
                    int64_t dlen, const uint32_t* cd, int ncd) {
    if (ncd < 8) return kCorrupt;
    if (cd[3] != 1) return kUnsupported;
    const int64_t n = cd[2];
    const int size = int(cd[4]), prec = int(cd[6]), off = int(cd[7]);
    const bool big = cd[5] == 1;
    if (size < 1 || size > 8 || n * size != dlen) return kSize;
    if (prec < 1 || prec + off > 8 * size) return kCorrupt;
    if (cd[1]) {                         // stored as they are
        if (slen < dlen) return kTruncated;
        std::memcpy(dst, src, size_t(dlen));
        return kOk;
    }
    if ((n * prec + 7) / 8 > slen) return kTruncated;
    Bits in(src, slen);
    for (int64_t i = 0; i < n; ++i) {
        uint64_t v;
        if (prec > 56) {
            v = in.get(prec - 32) << 32;
            v |= in.get(32);
        } else {
            v = in.get(prec);
        }
        store_le(dst + i * size, size, v << off);
    }
    if (big) swap_elements(dst, n, size);
    return kOk;
}

// One szip chunk.  cd (H5Zszip.c's parameters): [0] the options mask
// (SZ_MSB_OPTION_MASK 16: samples big-endian; SZ_NN_OPTION_MASK 32: nearest
// neighbour preprocessing; the others change nothing in the stream), [1]
// pixels per block, [2] bits per pixel, [3] pixels per scan line.  The
// chunk is HDF5's 4-byte little-endian decoded size, then the stream.  As
// libaec's SZ_BufftoBuffDecompress: 32- and 64-bit pixels are coded as
// their bytes, one byte plane after another, 8 bits a sample; where a
// scan line (of samples) is not whole blocks, each line is padded to
// whole blocks, the padding dropped here.
int h5c_szip_decode(const uint8_t* src, int64_t slen, uint8_t* dst,
                    int64_t dlen, const uint32_t* cd, int ncd) {
    if (ncd < 4) return kCorrupt;
    if (slen < 4) return kTruncated;
    if (int64_t(load_le(src, 4)) != dlen) return kSize;
    const uint32_t opts = cd[0];
    const int J = int(cd[1]), bpp = int(cd[2]);
    const int64_t pps = cd[3];
    if (J < 1 || J > 4096 || bpp < 1 || bpp > 64 || pps < 1) return kCorrupt;
    const bool interleave = bpp == 32 || bpp == 64;
    if (!interleave && bpp > 32) return kUnsupported;
    const int nbps = interleave ? 8 : bpp;
    const int bytes = nbps > 16 ? 4 : nbps > 8 ? 2 : 1;
    const int rsi = int((pps + J - 1) / J);
    const int64_t n = dlen / bytes;
    if (n * bytes != dlen) return kSize;
    // scan lines that are not whole blocks are padded to whole blocks
    const int64_t line = int64_t(rsi) * J;
    const int64_t lines = pps % J ? (n + pps - 1) / pps : 0;
    Bits in(src + 4, slen - 4);
    std::vector<uint32_t> v;
    const int st = aec_decode(in, nbps, J, rsi, opts & kSzNN,
                              lines ? lines * line : n, v);
    if (st) return st;
    if (lines)
        for (int64_t l = 1; l < lines; ++l)
            std::copy_n(v.begin() + l * line, std::min(pps, n - l * pps),
                        v.begin() + l * pps);
    if (!interleave) {
        put_samples(v, n, bytes, opts & kSzMsb, dst);
        return kOk;
    }
    // 32- and 64-bit pixels: one byte plane after another
    const int ws = bpp / 8;
    const int64_t words = dlen / ws;
    if (words * ws != dlen) return kSize;
    for (int64_t i = 0; i < words; ++i)
        for (int j = 0; j < ws; ++j)
            dst[i * ws + j] = uint8_t(v[size_t(j * words + i)]);
    return kOk;
}

}  // extern "C"
