// zarrcodec — the native codecs of the zarr stores: Blosc1 frames, standalone
// zstd frames and crc32c.
//
// The chunks of a zarr v2, zarr v3 or n5 store with blosc compression are
// Blosc1 frames.  This file decodes that frame format for every compressor
// c-blosc 1.x writes (BloscLZ, LZ4/LZ4HC and Snappy here; zlib and zstd
// through libz.so.1 and libzstd.so.1), with byte shuffle, bit shuffle and
// the memcpy flag, and encodes it for LZ4 with byte shuffle, over many chunks
// at once on a pool of threads.  It also decodes batches of standalone zstd
// frames (the zstd compressor of zarr v2 and n5, the zstd codec of zarr v3)
// and computes crc32c (the zarr v3 crc32c codec).  C ABI, consumed via
// ctypes:
//
//   zc_blosc_decode: decode n frames into n buffers, every block of every
//                    frame one job for n_threads threads;
//   zc_blosc_encode: encode n buffers into n frames (LZ4, byte shuffle or
//                    none), every block one job, then the frames assembled;
//   zc_zstd_decode:  decode n zstd frames into n buffers, one job each;
//   zc_zstd_content_size: the decoded size a zstd frame declares;
//   zc_snappy_decode: decode one raw Snappy stream (the format Blosc's
//                    snappy compressor writes into each stream of a block);
//   zc_crc32c:       CRC-32C (Castagnoli) of a buffer;
//   zc_libraries:    which of libz.so.1 (bit 0) and libzstd.so.1 (bit 1)
//                    load here.
//
// libz.so.1 and libzstd.so.1 are opened with dlopen at first use and their
// few entry points declared here, so the build needs neither zlib.h nor
// zstd.h: a machine with the shared libraries and no -dev package builds
// and decodes.  Without one of them a frame that needs it returns kLibrary.
//
// Frame layout (Blosc1): a 16-byte header {version, versionlz, flags,
// typesize, nbytes, blocksize, ctbytes}, then (unless the memcpy flag is
// set) one int32 start offset per block, then the blocks.  A block is split
// into `typesize` streams when the frame's "no split" flag (0x10) is clear,
// the block is not the leftover one, typesize <= 16 and blocksize / typesize
// >= 128 (c-blosc 1.x sets the flag whenever the last two fail, so the flag
// decides for every frame it writes, whatever the compressor); each stream
// is an int32 compressed size followed by its bytes, and a stream whose
// compressed size equals its raw size is stored raw.  Flags: 0x01 byte
// shuffle, 0x02 memcpy (the raw buffer follows the header, unshuffled), 0x04
// bit shuffle, 0x10 no split, bits 5-7 the compressor format (0 blosclz,
// 1 lz4 and lz4hc, 2 snappy, 3 zlib, 4 zstd).
//
// Snappy streams are raw Snappy: a varint of the decoded length, then
// literals and copies with 1-, 2- and 4-byte offsets; no libsnappy is
// loaded.  Anything else (a corrupt stream, a missing library) returns a
// negative status; the codec never hands back bytes it did not decode.
// Never throws.
#include <dlfcn.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kHeader = 16;
constexpr int kMinBuffer = 128;      // blosc MIN_BUFFERSIZE
constexpr int kMaxSplits = 16;       // blosc MAX_SPLITS
constexpr int kL1 = 32 * 1024;
constexpr uint8_t kShuffle = 0x01, kMemcpy = 0x02, kBitShuffle = 0x04,
                  kNoSplit = 0x10;
constexpr int kBloscLZFormat = 0, kLz4Format = 1, kSnappyFormat = 2,
              kZlibFormat = 3, kZstdFormat = 4;

// status codes (mirrored in zarr_store.py; -4, once "bit shuffle", is not
// returned any more)
constexpr int kOk = 0, kTruncated = -1, kVersion = -2, kCompressor = -3,
              kSize = -5, kCorrupt = -6, kLayout = -7, kLibrary = -8;

// ------------------------------------------------- libz.so.1, libzstd.so.1
struct Libraries {
    int (*uncompress)(uint8_t*, unsigned long*, const uint8_t*,
                      unsigned long) = nullptr;
    size_t (*zstd_decompress)(void*, size_t, const void*, size_t) = nullptr;
    unsigned (*zstd_is_error)(size_t) = nullptr;
    unsigned long long (*zstd_content_size)(const void*, size_t) = nullptr;
};

template <class F>
void bind(void* handle, const char* name, F* fn) {
    *fn = handle ? reinterpret_cast<F>(dlsym(handle, name)) : nullptr;
}

const Libraries& libraries() {
    static const Libraries libs = [] {
        Libraries l;
        void* z = dlopen("libz.so.1", RTLD_NOW | RTLD_LOCAL);
        bind(z, "uncompress", &l.uncompress);
        void* zs = dlopen("libzstd.so.1", RTLD_NOW | RTLD_LOCAL);
        bind(zs, "ZSTD_decompress", &l.zstd_decompress);
        bind(zs, "ZSTD_isError", &l.zstd_is_error);
        bind(zs, "ZSTD_getFrameContentSize", &l.zstd_content_size);
        if (!l.zstd_decompress || !l.zstd_is_error || !l.zstd_content_size)
            l.zstd_decompress = nullptr;
        return l;
    }();
    return libs;
}

constexpr unsigned long long kZstdUnknown = ~0ull, kZstdError = ~0ull - 1;

// Decode one zstd frame of exactly `dlen` bytes (the size it declares, where
// it declares one).
int zstd_decode(const uint8_t* src, int64_t slen, uint8_t* dst,
                int64_t dlen) {
    const Libraries& l = libraries();
    if (!l.zstd_decompress) return kLibrary;
    const unsigned long long declared = l.zstd_content_size(src, slen);
    if (declared == kZstdError) return kCorrupt;
    if (declared != kZstdUnknown && declared != (unsigned long long)dlen)
        return kSize;
    const size_t got = l.zstd_decompress(dst, (size_t)dlen, src, (size_t)slen);
    if (l.zstd_is_error(got) || got != (size_t)dlen) return kCorrupt;
    return kOk;
}

inline int32_t rd32(const uint8_t* p) {
    return (int32_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                     ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24));
}
inline void wr32(uint8_t* p, int32_t v) {
    uint32_t u = (uint32_t)v;
    p[0] = u & 255; p[1] = (u >> 8) & 255; p[2] = (u >> 16) & 255;
    p[3] = u >> 24;
}
inline uint32_t load32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

// ---------------------------------------------------------------- LZ4 block
// Decode one LZ4 block of exactly `dlen` output bytes.  Returns dlen, or -1
// for any malformed input (bounds are checked on every read and write).
int64_t lz4_decode(const uint8_t* src, int64_t slen, uint8_t* dst,
                   int64_t dlen) {
    const uint8_t* ip = src;
    const uint8_t* const iend = src + slen;
    uint8_t* op = dst;
    uint8_t* const oend = dst + dlen;
    while (ip < iend) {
        const unsigned token = *ip++;
        size_t lit = token >> 4;
        if (lit == 15) {
            unsigned s;
            do {
                if (ip >= iend) return -1;
                s = *ip++;
                lit += s;
            } while (s == 255);
        }
        if ((size_t)(iend - ip) < lit || (size_t)(oend - op) < lit)
            return -1;
        std::memcpy(op, ip, lit);
        op += lit;
        ip += lit;
        if (ip == iend) break;                 // the last sequence
        if (iend - ip < 2) return -1;
        const size_t off = (size_t)ip[0] | ((size_t)ip[1] << 8);
        ip += 2;
        if (off == 0 || off > (size_t)(op - dst)) return -1;
        size_t ml = token & 15;
        if (ml == 15) {
            unsigned s;
            do {
                if (ip >= iend) return -1;
                s = *ip++;
                ml += s;
            } while (s == 255);
        }
        ml += 4;
        if ((size_t)(oend - op) < ml) return -1;
        // overlapping copy: the distance stays a multiple of the offset
        size_t dist = off;
        while (ml) {
            const size_t n = ml < dist ? ml : dist;
            std::memcpy(op, op - dist, n);
            op += n;
            ml -= n;
            dist += n;
        }
    }
    return op == oend ? dlen : -1;
}

// ------------------------------------------------------------ BloscLZ block
// Decode one BloscLZ stream (c-blosc 1.x's FastLZ derivative) of exactly
// `dlen` output bytes.  The first byte's low 5 bits are a literal run's
// control byte; then a control byte below 32 is a run of ctrl + 1 literals,
// and one of 32 or more a match: length (ctrl >> 5) + 2, plus the bytes
// that follow while the 3-bit length field is 7 (each added, until one is
// not 255); distance ((ctrl & 31) << 8) + the next byte + 1, or, where that
// byte is 255 and the high bits are all set, 8192 + the next two bytes (big
// endian).  Returns dlen, or -1 for any malformed input.
// Raw Snappy: the decoded length as a little-endian base-128 varint, then
// elements, each a tag byte whose low two bits give its kind: 0 a literal
// (length - 1 in the upper six bits, or past 59 in the next 1-4 bytes),
// 1 a copy of 4-11 bytes with an 11-bit offset, 2 and 3 copies of 1-64
// bytes with a 2- and a 4-byte offset.  The bytes written, or a negative
// status; the stream must fill exactly the length it declares.
int64_t snappy_decode(const uint8_t* src, int64_t slen, uint8_t* dst,
                      int64_t dlen) {
    const uint8_t* ip = src;
    const uint8_t* const iend = src + slen;
    uint64_t n = 0;
    for (int shift = 0;; shift += 7) {
        if (ip >= iend || shift > 28) return kCorrupt;
        const uint8_t b = *ip++;
        n |= uint64_t(b & 0x7f) << shift;
        if (!(b & 0x80)) break;
    }
    if (n > (uint64_t)dlen) return kSize;
    uint8_t* op = dst;
    uint8_t* const oend = dst + n;
    while (ip < iend) {
        const uint8_t tag = *ip++;
        int64_t len, off = 0;
        switch (tag & 3) {
            case 0: {
                len = tag >> 2;
                if (len >= 60) {
                    const int w = (int)len - 59;
                    if (iend - ip < w) return kTruncated;
                    len = 0;
                    for (int i = w - 1; i >= 0; --i) len = (len << 8) | ip[i];
                    ip += w;
                }
                ++len;
                if (iend - ip < len) return kTruncated;
                if (oend - op < len) return kCorrupt;
                std::memcpy(op, ip, (size_t)len);
                op += len;
                ip += len;
                continue;
            }
            case 1:
                if (ip >= iend) return kTruncated;
                len = 4 + ((tag >> 2) & 7);
                off = (int64_t(tag >> 5) << 8) | *ip++;
                break;
            case 2:
                if (iend - ip < 2) return kTruncated;
                len = (tag >> 2) + 1;
                off = ip[0] | (int64_t(ip[1]) << 8);
                ip += 2;
                break;
            default:
                if (iend - ip < 4) return kTruncated;
                len = (tag >> 2) + 1;
                off = (int64_t)load32(ip);
                ip += 4;
        }
        if (off <= 0 || off > op - dst || oend - op < len) return kCorrupt;
        const uint8_t* ref = op - off;
        for (int64_t k = 0; k < len; ++k) op[k] = ref[k];
        op += len;
    }
    return op == oend ? (int64_t)n : kCorrupt;
}

int64_t blosclz_decode(const uint8_t* src, int64_t slen, uint8_t* dst,
                       int64_t dlen) {
    constexpr int64_t kMaxDistance = 8191;
    if (slen <= 0) return dlen == 0 ? 0 : -1;
    const uint8_t* ip = src;
    const uint8_t* const iend = src + slen;
    uint8_t* op = dst;
    uint8_t* const oend = dst + dlen;
    unsigned ctrl = *ip++ & 31u;
    for (;;) {
        if (ctrl >= 32) {
            int64_t len = (int64_t)(ctrl >> 5) - 1;
            int64_t ofs = (int64_t)(ctrl & 31) << 8;
            if (len == 6) {
                unsigned code;
                do {
                    if (ip >= iend) return -1;
                    code = *ip++;
                    len += code;
                } while (code == 255);
            }
            if (ip >= iend) return -1;
            const unsigned code = *ip++;
            len += 3;
            int64_t dist = ofs + code + 1;
            if (code == 255 && ofs == (31 << 8)) {
                if (iend - ip < 2) return -1;
                dist = (((int64_t)ip[0] << 8) | ip[1]) + kMaxDistance + 1;
                ip += 2;
            }
            if (oend - op < len || dist > op - dst) return -1;
            while (len) {              // overlapping copy, as LZ4's
                const int64_t n = len < dist ? len : dist;
                std::memcpy(op, op - dist, (size_t)n);
                op += n;
                len -= n;
                dist += n;
            }
        } else {
            const int64_t lit = (int64_t)ctrl + 1;
            if (oend - op < lit || iend - ip < lit) return -1;
            std::memcpy(op, ip, (size_t)lit);
            op += lit;
            ip += lit;
        }
        if (ip >= iend) break;
        ctrl = *ip++;
    }
    return op == oend ? dlen : -1;
}

// Greedy LZ4 block compressor (hash of 4-byte sequences, LZ4's end-of-block
// rules: the last match starts 12 bytes before the end or earlier, the last
// 5 bytes are literals).  Returns the compressed size, or 0 if it would not
// fit in `cap` bytes.
constexpr int kHashLog = 14;
constexpr int kMinMatch = 4, kLastLiterals = 5, kMfLimit = 12;

inline uint32_t lz4_hash(uint32_t v) {
    return (v * 2654435761u) >> (32 - kHashLog);
}

uint8_t* put_len(uint8_t* op, const uint8_t* oend, size_t len) {
    // the bytes after a token nibble of 15
    while (len >= 255) {
        if (op >= oend) return nullptr;
        *op++ = 255;
        len -= 255;
    }
    if (op >= oend) return nullptr;
    *op++ = (uint8_t)len;
    return op;
}

uint8_t* put_literals(uint8_t* op, const uint8_t* oend, const uint8_t* lit,
                      size_t n, unsigned match_nibble) {
    if (op >= oend) return nullptr;
    uint8_t* token = op++;
    if (n >= 15) {
        *token = (uint8_t)((15 << 4) | match_nibble);
        op = put_len(op, oend, n - 15);
        if (!op) return nullptr;
    } else {
        *token = (uint8_t)((n << 4) | match_nibble);
    }
    if ((size_t)(oend - op) < n) return nullptr;
    std::memcpy(op, lit, n);
    return op + n;
}

int64_t lz4_encode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap,
                   int32_t* table, int accel) {
    uint8_t* op = dst;
    const uint8_t* const oend = dst + cap;
    int64_t anchor = 0;
    if (n >= kMfLimit + 1) {
        std::fill(table, table + (1 << kHashLog), -1);
        const int64_t mflimit = n - kMfLimit;
        const int64_t matchlimit = n - kLastLiterals;
        int64_t ip = 0;
        while (ip <= mflimit) {
            // find a match, skipping faster through incompressible runs
            int64_t ref = -1;
            unsigned attempts = (unsigned)accel << 6;
            while (ip <= mflimit) {
                const uint32_t seq = load32(src + ip);
                const uint32_t h = lz4_hash(seq);
                ref = table[h];
                table[h] = (int32_t)ip;
                if (ref >= 0 && ip - ref <= 65535 &&
                    load32(src + ref) == seq)
                    break;
                ref = -1;
                ip += attempts++ >> 6;
            }
            if (ref < 0) break;
            while (ip > anchor && ref > 0 && src[ip - 1] == src[ref - 1]) {
                --ip;
                --ref;
            }
            int64_t ml = kMinMatch;
            while (ip + ml < matchlimit && src[ip + ml] == src[ref + ml])
                ++ml;
            const size_t mcode = (size_t)(ml - kMinMatch);
            op = put_literals(op, oend, src + anchor, (size_t)(ip - anchor),
                              mcode >= 15 ? 15 : (unsigned)mcode);
            if (!op || oend - op < 2) return 0;
            const int64_t off = ip - ref;
            *op++ = (uint8_t)(off & 255);
            *op++ = (uint8_t)(off >> 8);
            if (mcode >= 15) {
                op = put_len(op, oend, mcode - 15);
                if (!op) return 0;
            }
            ip += ml;
            anchor = ip;
            if (ip - 2 >= 0 && ip <= mflimit)
                table[lz4_hash(load32(src + ip - 2))] = (int32_t)(ip - 2);
        }
    }
    op = put_literals(op, oend, src + anchor, (size_t)(n - anchor), 0);
    return op ? (int64_t)(op - dst) : 0;
}

// ------------------------------------------------------------- byte shuffle
void shuffle(int ts, int64_t n, const uint8_t* src, uint8_t* dst) {
    const int64_t ne = n / ts;
    for (int64_t i = 0; i < ne; ++i)
        for (int j = 0; j < ts; ++j) dst[j * ne + i] = src[i * ts + j];
    std::memcpy(dst + ne * ts, src + ne * ts, (size_t)(n - ne * ts));
}

void unshuffle(int ts, int64_t n, const uint8_t* src, uint8_t* dst) {
    const int64_t ne = n / ts;
    if (ts == 4) {
        const uint8_t *a = src, *b = src + ne, *c = src + 2 * ne,
                      *d = src + 3 * ne;
        for (int64_t i = 0; i < ne; ++i) {
            dst[4 * i] = a[i]; dst[4 * i + 1] = b[i];
            dst[4 * i + 2] = c[i]; dst[4 * i + 3] = d[i];
        }
    } else {
        for (int64_t i = 0; i < ne; ++i)
            for (int j = 0; j < ts; ++j) dst[i * ts + j] = src[j * ne + i];
    }
    std::memcpy(dst + ne * ts, src + ne * ts, (size_t)(n - ne * ts));
}

// Undo bitshuffle's bit transpose of a block of n bytes (elements of ts
// bytes): in the shuffled block, row (j, k) of ne / 8 bytes holds bit k of
// byte j of every element, element i at bit i % 8 of byte i / 8.  As in
// c-blosc 1.x (checked against libblosc 1.21), a block whose element count
// is not a multiple of 8 was not transposed at all and is copied as is.
inline uint64_t transpose8x8(uint64_t x) {
    // bit k of byte m <-> bit m of byte k
    uint64_t t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
    x ^= t ^ (t << 7);
    t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
    x ^= t ^ (t << 14);
    t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
    return x ^ t ^ (t << 28);
}

void bitunshuffle(int ts, int64_t n, const uint8_t* src, uint8_t* dst) {
    const int64_t ne = n / ts % 8 ? 0 : n / ts, row = ne / 8;
    for (int j = 0; j < ts; ++j) {
        const uint8_t* rows = src + (int64_t)j * 8 * row;
        for (int64_t g = 0; g < row; ++g) {
            uint64_t x = 0;
            for (int k = 0; k < 8; ++k)
                x |= (uint64_t)rows[k * row + g] << (8 * k);
            x = transpose8x8(x);
            uint8_t* out = dst + g * 8 * ts + j;
            for (int m = 0; m < 8; ++m) out[m * ts] = (uint8_t)(x >> (8 * m));
        }
    }
    std::memcpy(dst + ne * ts, src + ne * ts, (size_t)(n - ne * ts));
}

bool split_block(int ts, int64_t blocksize) {
    // c-blosc 1.x's forward-compatible rule
    return ts <= kMaxSplits && blocksize / ts >= kMinBuffer;
}

// c-blosc 1.x's automatic block size for LZ4
int64_t auto_blocksize(int clevel, int ts, int64_t nbytes) {
    if (nbytes < ts) return 1;
    int64_t bs = nbytes;
    if (nbytes >= kL1) {
        bs = kL1;
        static const int mult[10] = {0, 0, 1, 2, 4, 4, 8, 8, 8, 8};
        if (clevel == 0) bs /= 4;
        else if (clevel == 1) bs /= 2;
        else bs *= mult[std::min(clevel, 9)];
    }
    if (clevel > 0 && split_block(ts, bs)) {
        if (bs > (1 << 18)) bs = 1 << 18;
        bs *= ts;
        if (bs < (1 << 16)) bs = 1 << 16;
        if (bs > 1024 * 1024) bs = 1024 * 1024;
    }
    if (bs > nbytes) bs = nbytes;
    if (bs > ts) bs = bs / ts * ts;
    return bs;
}

struct Frame {
    int flags = 0, ts = 1;
    int64_t nbytes = 0, blocksize = 0, ctbytes = 0, nblocks = 0;
};

int parse_header(const uint8_t* p, int64_t len, Frame* f) {
    if (len < kHeader) return kTruncated;
    if (p[0] == 0 || p[0] > 2) return kVersion;
    f->flags = p[2];
    f->ts = p[3] ? p[3] : 1;
    f->nbytes = rd32(p + 4);
    f->blocksize = rd32(p + 8);
    f->ctbytes = rd32(p + 12);
    if (f->nbytes < 0 || f->blocksize < 0 || f->ctbytes < kHeader)
        return kLayout;
    if (f->ctbytes > len) return kTruncated;
    if (f->flags & kMemcpy) {
        if (f->ctbytes != f->nbytes + kHeader) return kLayout;
        return kOk;
    }
    switch ((f->flags >> 5) & 7) {
        case kBloscLZFormat: case kLz4Format: case kSnappyFormat: break;
        case kZlibFormat:
            if (!libraries().uncompress) return kLibrary;
            break;
        case kZstdFormat:
            if (!libraries().zstd_decompress) return kLibrary;
            break;
        default: return kCompressor;
    }
    if (f->nbytes == 0) return kOk;
    if (f->blocksize <= 0) return kLayout;
    f->nblocks = (f->nbytes + f->blocksize - 1) / f->blocksize;
    if (kHeader + 4 * f->nblocks > f->ctbytes) return kLayout;
    return kOk;
}

// Decode one stream of a block: exactly dlen bytes, or false.
bool decode_stream(int format, const uint8_t* src, int64_t slen, uint8_t* dst,
                   int64_t dlen) {
    switch (format) {
        case kBloscLZFormat: return blosclz_decode(src, slen, dst, dlen) == dlen;
        case kLz4Format: return lz4_decode(src, slen, dst, dlen) == dlen;
        case kSnappyFormat:
            return snappy_decode(src, slen, dst, dlen) == dlen;
        case kZlibFormat: {
            unsigned long got = (unsigned long)dlen;
            return libraries().uncompress(dst, &got, src,
                                          (unsigned long)slen) == 0 &&
                   got == (unsigned long)dlen;
        }
        case kZstdFormat: return zstd_decode(src, slen, dst, dlen) == kOk;
    }
    return false;
}

// Decode block b of frame f (source p) into dst (the whole output buffer).
int decode_block(const uint8_t* p, const Frame& f, int64_t b, uint8_t* dst,
                 std::vector<uint8_t>& tmp) {
    const bool leftover = b == f.nblocks - 1 && f.nbytes % f.blocksize;
    const int64_t bsize = leftover ? f.nbytes % f.blocksize : f.blocksize;
    const int64_t start = rd32(p + kHeader + 4 * b);
    if (start < kHeader + 4 * f.nblocks || start > f.ctbytes) return kLayout;
    // c-blosc 1.x: byte shuffle wins where both flags are set
    const bool shuffled = (f.flags & kShuffle) && f.ts > 1;
    const bool bitshuffled = !shuffled && (f.flags & kBitShuffle) &&
                             bsize >= f.ts;
    const int nsplits = (!(f.flags & kNoSplit) && !leftover &&
                         split_block(f.ts, f.blocksize)) ? f.ts : 1;
    const int64_t neblock = bsize / nsplits;
    if (neblock * nsplits != bsize) return kLayout;
    uint8_t* out = dst + b * f.blocksize;
    if (shuffled || bitshuffled) {
        if ((int64_t)tmp.size() < bsize) tmp.resize(bsize);
        out = tmp.data();
    }
    const int format = (f.flags >> 5) & 7;
    const uint8_t* ip = p + start;
    const uint8_t* const iend = p + f.ctbytes;
    for (int j = 0; j < nsplits; ++j) {
        if (iend - ip < 4) return kLayout;
        const int64_t cbytes = rd32(ip);
        ip += 4;
        if (cbytes < 0 || cbytes > iend - ip) return kLayout;
        if (cbytes == neblock) {
            std::memcpy(out, ip, (size_t)neblock);
        } else if (!decode_stream(format, ip, cbytes, out, neblock)) {
            return kCorrupt;
        }
        ip += cbytes;
        out += neblock;
    }
    if (shuffled) unshuffle(f.ts, bsize, tmp.data(), dst + b * f.blocksize);
    if (bitshuffled)
        bitunshuffle(f.ts, bsize, tmp.data(), dst + b * f.blocksize);
    return kOk;
}

template <class F>
void run_jobs(int64_t n_jobs, int n_threads, F&& job) {
    std::atomic<int64_t> next(0);
    auto work = [&]() {
        for (int64_t j; (j = next.fetch_add(1)) < n_jobs;) job(j);
    };
    n_threads = (int)std::max<int64_t>(1, std::min<int64_t>(n_threads,
                                                            n_jobs));
    std::vector<std::thread> threads;
    for (int t = 1; t < n_threads; ++t) threads.emplace_back(work);
    work();
    for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Decode frame i (src[i], src_len[i] bytes) into dst[i], which must hold
// exactly the frame's nbytes (dst_len[i]).  status[i] gets 0 or a negative
// code; returns the first nonzero status (0 if every frame decoded).  A
// frame with a nonzero status leaves its dst in an unspecified state.
int zc_blosc_decode(int64_t n, const uint8_t* const* src,
                    const int64_t* src_len, uint8_t* const* dst,
                    const int64_t* dst_len, int32_t* status, int n_threads) {
    std::vector<Frame> frames(n);
    std::vector<int64_t> first(n + 1, 0);   // first job of each frame
    for (int64_t i = 0; i < n; ++i) {
        int rc = parse_header(src[i], src_len[i], &frames[i]);
        if (rc == kOk && frames[i].nbytes != dst_len[i]) rc = kSize;
        status[i] = rc;
        const Frame& f = frames[i];
        const int64_t jobs = rc != kOk ? 0
            : (f.flags & kMemcpy) ? (f.nbytes > 0) : f.nblocks;
        first[i + 1] = first[i] + jobs;
    }
    std::vector<std::atomic<int32_t>> bad(n);
    for (auto& b : bad) b.store(0);
    run_jobs(first[n], n_threads, [&](int64_t j) {
        thread_local std::vector<uint8_t> tmp;
        const int64_t i = std::upper_bound(first.begin(), first.end(), j)
                          - first.begin() - 1;
        const Frame& f = frames[i];
        if (f.flags & kMemcpy) {
            std::memcpy(dst[i], src[i] + kHeader, (size_t)f.nbytes);
            return;
        }
        const int rc = decode_block(src[i], f, j - first[i], dst[i], tmp);
        if (rc != kOk) {
            int32_t zero = 0;
            bad[i].compare_exchange_strong(zero, rc);
        }
    });
    int first_bad = kOk;
    for (int64_t i = 0; i < n; ++i) {
        if (status[i] == kOk) status[i] = bad[i].load();
        if (status[i] != kOk && first_bad == kOk) first_bad = status[i];
    }
    return first_bad;
}

// Encode buffer i (src[i], nbytes[i] bytes of elements of `typesize` bytes)
// into a frame at dst[i] (capacity cap[i] >= nbytes[i] + 16); out_len[i]
// gets the frame's size.  LZ4 at `clevel` (0 stores the buffer as a memcpy
// frame), byte shuffle if `doshuffle`.  Returns 0, or kSize if a capacity
// is short.
int zc_blosc_encode(int64_t n, const uint8_t* const* src,
                    const int64_t* nbytes, int typesize, int clevel,
                    int doshuffle, uint8_t* const* dst, const int64_t* cap,
                    int64_t* out_len, int n_threads) {
    const int ts = std::max(1, std::min(typesize, 255));
    clevel = std::max(0, std::min(clevel, 9));
    const int accel = 1;
    std::vector<int64_t> bsz(n), nblk(n), first(n + 1, 0);
    for (int64_t i = 0; i < n; ++i) {
        if (cap[i] < nbytes[i] + kHeader) return kSize;
        const bool raw = clevel == 0 || nbytes[i] < kMinBuffer;
        bsz[i] = raw ? 0 : auto_blocksize(clevel, ts, nbytes[i]);
        nblk[i] = raw ? 0 : (nbytes[i] + bsz[i] - 1) / bsz[i];
        first[i + 1] = first[i] + nblk[i];
    }
    // each block into its own buffer: [int32 cbytes, bytes] per stream
    std::vector<std::vector<uint8_t>> blocks(first[n]);
    run_jobs(first[n], n_threads, [&](int64_t j) {
        thread_local std::vector<uint8_t> shuf;
        thread_local std::vector<int32_t> table(1 << kHashLog);
        const int64_t i = std::upper_bound(first.begin(), first.end(), j)
                          - first.begin() - 1;
        const int64_t b = j - first[i];
        const bool leftover = b == nblk[i] - 1 && nbytes[i] % bsz[i];
        const int64_t bsize = leftover ? nbytes[i] % bsz[i] : bsz[i];
        const uint8_t* in = src[i] + b * bsz[i];
        if (doshuffle && ts > 1) {
            if ((int64_t)shuf.size() < bsize) shuf.resize(bsize);
            shuffle(ts, bsize, in, shuf.data());
            in = shuf.data();
        }
        const int nsplits = (!leftover && split_block(ts, bsz[i])) ? ts : 1;
        const int64_t neblock = bsize / nsplits;
        std::vector<uint8_t>& out = blocks[j];
        out.resize((size_t)(bsize + 4 * nsplits));
        int64_t pos = 0;
        for (int s = 0; s < nsplits; ++s) {
            const uint8_t* stream = in + s * neblock;
            int64_t cb = lz4_encode(stream, neblock, out.data() + pos + 4,
                                    neblock - 1, table.data(), accel);
            if (cb <= 0 || cb >= neblock) {     // incompressible: raw
                cb = neblock;
                std::memcpy(out.data() + pos + 4, stream, (size_t)neblock);
            }
            wr32(out.data() + pos, (int32_t)cb);
            pos += 4 + cb;
        }
        out.resize((size_t)pos);
    });
    run_jobs(n, n_threads, [&](int64_t i) {
        uint8_t* d = dst[i];
        const int64_t nb = nbytes[i];
        int64_t total = kHeader + 4 * nblk[i];
        for (int64_t b = 0; b < nblk[i]; ++b)
            total += (int64_t)blocks[first[i] + b].size();
        const bool memcpyed = nblk[i] == 0 || total > nb + kHeader;
        d[0] = 2;                       // Blosc1 frame format
        d[1] = 1;                       // LZ4 format version
        d[2] = (uint8_t)((kLz4Format << 5) |
                         (doshuffle && ts > 1 ? kShuffle : 0) |
                         (memcpyed ? kMemcpy : 0) |
                         (bsz[i] && !split_block(ts, bsz[i]) ? kNoSplit : 0));
        d[3] = (uint8_t)ts;
        wr32(d + 4, (int32_t)nb);
        wr32(d + 8, (int32_t)(bsz[i] ? bsz[i] : nb));
        if (memcpyed) {
            std::memcpy(d + kHeader, src[i], (size_t)nb);
            wr32(d + 12, (int32_t)(nb + kHeader));
            out_len[i] = nb + kHeader;
            return;
        }
        int64_t pos = kHeader + 4 * nblk[i];
        for (int64_t b = 0; b < nblk[i]; ++b) {
            const std::vector<uint8_t>& blk = blocks[first[i] + b];
            wr32(d + kHeader + 4 * b, (int32_t)pos);
            std::memcpy(d + pos, blk.data(), blk.size());
            pos += (int64_t)blk.size();
        }
        wr32(d + 12, (int32_t)pos);
        out_len[i] = pos;
    });
    return kOk;
}

// Decode zstd frame i (src[i], src_len[i] bytes) into dst[i], which must
// hold exactly its decoded size (dst_len[i]); one job per frame.  status[i]
// gets 0, kSize (the frame declares another size), kCorrupt or kLibrary;
// returns the first nonzero status.
int zc_zstd_decode(int64_t n, const uint8_t* const* src,
                   const int64_t* src_len, uint8_t* const* dst,
                   const int64_t* dst_len, int32_t* status, int n_threads) {
    run_jobs(n, n_threads, [&](int64_t i) {
        status[i] = zstd_decode(src[i], src_len[i], dst[i], dst_len[i]);
    });
    for (int64_t i = 0; i < n; ++i)
        if (status[i] != kOk) return status[i];
    return kOk;
}

// The decoded size the zstd frame at src declares: -1 if it declares none,
// -2 if it is not a zstd frame, kLibrary without libzstd.so.1.
int64_t zc_zstd_content_size(const uint8_t* src, int64_t len) {
    const Libraries& l = libraries();
    if (!l.zstd_decompress) return kLibrary;
    const unsigned long long s = l.zstd_content_size(src, (size_t)len);
    return s == kZstdUnknown ? -1 : s == kZstdError ? -2 : (int64_t)s;
}

// CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) of n bytes, as the
// zarr v3 crc32c codec stores it.
// One raw Snappy stream into dst (dlen bytes of room): the bytes decoded,
// or a negative status.
int64_t zc_snappy_decode(const uint8_t* src, int64_t slen, uint8_t* dst,
                         int64_t dlen) {
    return snappy_decode(src, slen, dst, dlen);
}

uint32_t zc_crc32c(const uint8_t* p, int64_t n) {
    static const auto table = [] {
        std::vector<uint32_t> t(256);
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t c = i;
            for (int k = 0; k < 8; ++k)
                c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
            t[i] = c;
        }
        return t;
    }();
    uint32_t c = ~0u;
    for (int64_t i = 0; i < n; ++i) c = table[(c ^ p[i]) & 255] ^ (c >> 8);
    return ~c;
}

// Bit 0: libz.so.1 loads here; bit 1: libzstd.so.1 does.
int zc_libraries() {
    const Libraries& l = libraries();
    return (l.uncompress ? 1 : 0) | (l.zstd_decompress ? 2 : 0);
}

}  // extern "C"
