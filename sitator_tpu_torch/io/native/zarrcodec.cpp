// zarrcodec — Blosc1 frames with LZ4 blocks and byte shuffle, for zarr stores.
//
// The chunks of a zarr v2 store written with the default compressor
// ({"id": "blosc", "cname": "lz4", "shuffle": -1}) and of an n5 store with
// blosc compression are Blosc1 frames.  This file decodes and encodes that
// frame format for the one compressor it carries (LZ4), with byte shuffle
// and the memcpy flag, over many chunks at once on a pool of threads.  C ABI,
// consumed via ctypes:
//
//   zc_blosc_decode: decode n frames into n buffers, every block of every
//                    frame one job for n_threads threads;
//   zc_blosc_encode: encode n buffers into n frames (LZ4, byte shuffle or
//                    none), every block one job, then the frames assembled.
//
// Frame layout (Blosc1): a 16-byte header {version, versionlz, flags,
// typesize, nbytes, blocksize, ctbytes}, then (unless the memcpy flag is
// set) one int32 start offset per block, then the blocks.  A block is split
// into `typesize` streams when the frame's "no split" flag (0x10) is clear,
// the block is not the leftover one, typesize <= 16 and blocksize / typesize
// >= 128; each stream is an int32 compressed size followed by its bytes, and
// a stream whose compressed size equals its raw size is stored raw.  Flags:
// 0x01 byte shuffle, 0x02 memcpy (the raw buffer follows the header,
// unshuffled), 0x04 bit shuffle, 0x10 no split, bits 5-7 the compressor
// format (0 blosclz, 1 lz4, 2 snappy, 3 zlib, 4 zstd).
//
// Anything else (another compressor format, bit shuffle, a corrupt stream)
// returns a negative status; the codec never hands back bytes it did not
// decode.  Never throws.
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
constexpr int kLz4Format = 1;

// status codes (mirrored in zarr_store.py)
constexpr int kOk = 0, kTruncated = -1, kVersion = -2, kCompressor = -3,
              kBitShuffled = -4, kSize = -5, kCorrupt = -6, kLayout = -7;

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

bool split_block(int ts, int64_t blocksize) {
    // c-blosc 1.x's forward-compatible rule for LZ4
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
    if (((f->flags >> 5) & 7) != kLz4Format) return kCompressor;
    if (f->flags & kBitShuffle) return kBitShuffled;
    if (f->nbytes == 0) return kOk;
    if (f->blocksize <= 0) return kLayout;
    f->nblocks = (f->nbytes + f->blocksize - 1) / f->blocksize;
    if (kHeader + 4 * f->nblocks > f->ctbytes) return kLayout;
    return kOk;
}

// Decode block b of frame f (source p) into dst (the whole output buffer).
int decode_block(const uint8_t* p, const Frame& f, int64_t b, uint8_t* dst,
                 std::vector<uint8_t>& tmp) {
    const bool leftover = b == f.nblocks - 1 && f.nbytes % f.blocksize;
    const int64_t bsize = leftover ? f.nbytes % f.blocksize : f.blocksize;
    const int64_t start = rd32(p + kHeader + 4 * b);
    if (start < kHeader + 4 * f.nblocks || start > f.ctbytes) return kLayout;
    const bool shuffled = (f.flags & kShuffle) && f.ts > 1;
    const int nsplits = (!(f.flags & kNoSplit) && !leftover &&
                         split_block(f.ts, f.blocksize)) ? f.ts : 1;
    const int64_t neblock = bsize / nsplits;
    if (neblock * nsplits != bsize) return kLayout;
    uint8_t* out = dst + b * f.blocksize;
    if (shuffled) {
        if ((int64_t)tmp.size() < bsize) tmp.resize(bsize);
        out = tmp.data();
    }
    const uint8_t* ip = p + start;
    const uint8_t* const iend = p + f.ctbytes;
    for (int j = 0; j < nsplits; ++j) {
        if (iend - ip < 4) return kLayout;
        const int64_t cbytes = rd32(ip);
        ip += 4;
        if (cbytes < 0 || cbytes > iend - ip) return kLayout;
        if (cbytes == neblock) {
            std::memcpy(out, ip, (size_t)neblock);
        } else if (lz4_decode(ip, cbytes, out, neblock) != neblock) {
            return kCorrupt;
        }
        ip += cbytes;
        out += neblock;
    }
    if (shuffled) unshuffle(f.ts, bsize, tmp.data(), dst + b * f.blocksize);
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

}  // extern "C"
