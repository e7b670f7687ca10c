// fastxyz — multithreaded extended-XYZ trajectory decoder.
//
// Native data-loader for the streaming pipeline (SURVEY.md §3.9 item 5: the
// reference delegates trajectory IO to ASE's C-backed readers; this is the
// sitator_tpu equivalent, built for feeding frame blocks to the device at
// HBM-filling rates).  Two entry points, C ABI, consumed via ctypes:
//
//   fxyz_index:      scan the file once, recording the byte offset and atom
//                    count of every frame (enables random block access);
//   fxyz_read_block: decode a contiguous range of frames into a float32
//                    (n, n_atoms, 3) buffer, frames parsed in parallel.
//
// The parser is deliberately minimal: species tokens are skipped (the
// structure comes from frame 0 via the Python side), positions are read with
// a fast inline float scanner.  Returns negative error codes; never throws.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cctype>
#include <string>
#include <thread>
#include <vector>
#include <atomic>

extern "C" {

// Scan the file; fill offsets[0..max_frames) with byte offsets of each
// frame's first line.  Returns the number of frames found (may exceed
// max_frames — call again with a larger buffer), or <0 on error.
// n_atoms_out receives the (uniform) atom count, -2 if inconsistent.
//
// Implementation: bulk 4 MB reads + memchr newline hops — no per-line
// fgets, and no line-length limit (extxyz comment lines carry arbitrary
// per-frame metadata and may exceed any fixed buffer).  Only the short
// natoms header lines are materialized across chunk boundaries.
int64_t fxyz_index(const char* path, int64_t* offsets, int64_t max_frames,
                   int64_t* n_atoms_out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    const size_t CHUNK = (size_t)1 << 22;
    std::vector<char> buf(CHUNK);
    std::string header;          // partial natoms-line carried across chunks
    int64_t n_frames = 0;
    int64_t n_atoms = -1;
    int64_t skip = 0;            // lines to swallow before the next header
    bool in_header = false;
    int64_t header_start = 0;
    int64_t base = 0;            // absolute offset of buf[0]
    for (;;) {
        size_t got = std::fread(buf.data(), 1, CHUNK, f);
        if (got == 0) break;
        const char* p = buf.data();
        const char* end = buf.data() + got;
        while (p < end) {
            if (skip > 0) {
                const char* nl = (const char*)memchr(p, '\n',
                                                     (size_t)(end - p));
                if (!nl) { p = end; break; }
                p = nl + 1;
                --skip;
                continue;
            }
            if (!in_header) {
                in_header = true;
                header.clear();
                header_start = base + (p - buf.data());
            }
            const char* nl = (const char*)memchr(p, '\n',
                                                 (size_t)(end - p));
            const char* stop = nl ? nl : end;
            if (header.size() + (size_t)(stop - p) > (size_t)1 << 20) {
                std::fclose(f); return -3;   // absurd natoms line
            }
            header.append(p, stop);
            if (!nl) { p = end; break; }
            p = nl + 1;
            in_header = false;
            const char* h = header.c_str();
            while (*h == ' ' || *h == '\t' || *h == '\r') ++h;
            if (*h == '\0') continue;        // blank line between frames
            char* after = nullptr;
            long na = std::strtol(h, &after, 10);
            if (na <= 0 || after == h) { std::fclose(f); return -3; }
            if (n_atoms < 0) n_atoms = na;
            else if (n_atoms != na) { std::fclose(f); *n_atoms_out = -2;
                                      return n_frames; }
            if (n_frames < max_frames) offsets[n_frames] = header_start;
            ++n_frames;
            skip = (int64_t)na + 1;          // comment + atom lines
        }
        base += (int64_t)got;
        if (got < CHUNK) break;
    }
    std::fclose(f);
    if (skip > 1) return -4;                 // truncated final frame
    if (in_header) {
        // text after the last complete frame with no trailing newline
        const char* h = header.c_str();
        while (*h == ' ' || *h == '\t' || *h == '\r') ++h;
        if (*h != '\0') return -4;
    }
    *n_atoms_out = n_atoms;
    return n_frames;
}

static inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

static inline const char* skip_token(const char* p, const char* end) {
    while (p < end && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r')
        ++p;
    return p;
}

static inline const char* next_line(const char* p, const char* end) {
    while (p < end && *p != '\n') ++p;
    return p < end ? p + 1 : end;
}

// Fast float scan: sign, integer, fraction, exponent.  Positions in MD
// files are plain decimals.  *ok is cleared when the token has no digits
// (nan/inf/corrupt text) so the decoder errors instead of writing 0.0.
static inline const char* parse_float(const char* p, const char* end,
                                      float* out, bool* ok) {
    p = skip_ws(p, end);
    bool neg = false;
    bool any = false;
    if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
    double v = 0.0;
    while (p < end && (unsigned)(*p - '0') < 10u) {
        v = v * 10.0 + (*p - '0'); ++p; any = true;
    }
    if (p < end && *p == '.') {
        ++p;
        double scale = 0.1;
        while (p < end && (unsigned)(*p - '0') < 10u) {
            v += (*p - '0') * scale; scale *= 0.1; ++p; any = true;
        }
    }
    if (!any) *ok = false;
    if (p < end && (*p == 'e' || *p == 'E')) {
        ++p;
        bool eneg = false;
        if (p < end && (*p == '-' || *p == '+')) { eneg = (*p == '-'); ++p; }
        long ex = 0;
        while (p < end && (unsigned)(*p - '0') < 10u) {
            ex = ex * 10 + (*p - '0'); ++p;
        }
        double mul = 1.0;
        double base = eneg ? 0.1 : 10.0;
        for (long i = 0; i < ex; ++i) mul *= base;
        v *= mul;
    }
    *out = (float)(neg ? -v : v);
    return p;
}

// Parse one frame's atom block (text between begin/end) into out[n_atoms*3].
static int parse_frame(const char* begin, const char* end, int64_t n_atoms,
                       float* out) {
    const char* p = begin;
    p = next_line(p, end);   // natoms line
    p = next_line(p, end);   // comment line
    for (int64_t i = 0; i < n_atoms; ++i) {
        p = skip_ws(p, end);
        p = skip_token(p, end);               // species symbol
        bool ok = true;
        for (int c = 0; c < 3; ++c)
            p = parse_float(p, end, out + i * 3 + c, &ok);
        if (!ok) return -7;                   // nan/inf/corrupt coordinate
        p = next_line(p, end);
        if (p >= end && i + 1 < n_atoms) return -1;
    }
    return 0;
}

// Decode frames [first, first+n_frames) into out (n_frames*n_atoms*3 f32).
// offsets must contain at least first+n_frames+? entries; file_size bounds
// the final frame.  Parses frames across n_threads.
int fxyz_read_block(const char* path, const int64_t* offsets,
                    int64_t n_total_frames, int64_t file_size,
                    int64_t first, int64_t n_frames, int64_t n_atoms,
                    float* out, int n_threads) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    int64_t begin_off = offsets[first];
    int64_t end_off = (first + n_frames < n_total_frames)
                          ? offsets[first + n_frames] : file_size;
    int64_t span = end_off - begin_off;
    std::vector<char> buf((size_t)span);
    if (std::fseek(f, (long)begin_off, SEEK_SET) != 0) { std::fclose(f);
                                                         return -2; }
    if ((int64_t)std::fread(buf.data(), 1, (size_t)span, f) != span) {
        std::fclose(f); return -3;
    }
    std::fclose(f);

    if (n_threads < 1) n_threads = 1;
    std::atomic<int> err{0};
    auto work = [&](int t) {
        for (int64_t i = t; i < n_frames; i += n_threads) {
            const char* b = buf.data() + (offsets[first + i] - begin_off);
            const char* e = (first + i + 1 < n_total_frames)
                ? buf.data() + (offsets[first + i + 1] - begin_off)
                : buf.data() + span;
            if (parse_frame(b, e, n_atoms, out + i * n_atoms * 3) != 0)
                err.store(-4);
        }
    };
    std::vector<std::thread> threads;
    for (int t = 1; t < n_threads; ++t) threads.emplace_back(work, t);
    work(0);
    for (auto& th : threads) th.join();
    return err.load();
}

}  // extern "C"
