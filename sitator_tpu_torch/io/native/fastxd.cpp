// fastxd — multithreaded VASP XDATCAR trajectory decoder.
//
// Third native data-loader (SURVEY.md §3.9 item 5), alongside fastxyz and
// fastlmp.  The Python wrapper parses the (fixed-cell) header and hands
// over `n_atoms` and the header's end offset; frames are then uniform
// "Direct configuration=" lines followed by n_atoms fractional-coordinate
// lines.  Fractional→cartesian happens in numpy after the block decode.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <thread>
#include <atomic>

namespace {

inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

inline const char* next_line(const char* p, const char* end) {
    while (p < end && *p != '\n') ++p;
    return p < end ? p + 1 : end;
}

inline const char* parse_float(const char* p, const char* end, float* out,
                               bool* ok) {
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
    if (!any) *ok = false;
    *out = (float)(neg ? -v : v);
    return p;
}

}  // namespace

extern "C" {

// Scan frames starting at header_end: each frame is one
// "Direct configuration=" line followed by n_atoms coordinate lines.
// Header lines are materialized (carried across chunk boundaries) and the
// full "Direct"/"direct" token is matched, so a variable-cell XDATCAR —
// which repeats its comment/cell header mid-file — fails the index with
// -3 and the Python side falls back to the clearer eager reader.
// Returns the frame count (may exceed max_frames), or <0 on error.
int64_t fxd_index(const char* path, int64_t header_end, int64_t n_atoms,
                  int64_t* offsets, int64_t max_frames) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    if (std::fseek(f, (long)header_end, SEEK_SET) != 0) { std::fclose(f);
                                                          return -2; }
    const size_t CHUNK = (size_t)1 << 22;
    std::vector<char> buf(CHUNK);
    std::string hline;            // header line carried across chunks
    int64_t n_frames = 0;
    int64_t skip = 0;
    bool in_hline = false;
    int64_t line_start = 0;
    int64_t base = header_end;
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
            if (!in_hline) {
                in_hline = true;
                hline.clear();
                line_start = base + (p - buf.data());
            }
            const char* nl = (const char*)memchr(p, '\n',
                                                 (size_t)(end - p));
            const char* stop = nl ? nl : end;
            if (hline.size() + (size_t)(stop - p) > (size_t)1 << 20) {
                std::fclose(f); return -3;
            }
            hline.append(p, stop);
            if (!nl) { p = end; break; }
            p = nl + 1;
            in_hline = false;
            const char* h = hline.c_str();
            while (*h == ' ' || *h == '\t' || *h == '\r') ++h;
            if (*h == '\0') continue;                 // blank line
            if (std::strncmp(h, "Direct", 6) != 0
                && std::strncmp(h, "direct", 6) != 0) {
                std::fclose(f); return -3;            // e.g. NPT header
            }
            if (n_frames < max_frames)
                offsets[n_frames] = line_start;
            ++n_frames;
            skip = n_atoms;                           // coordinate lines
        }
        base += (int64_t)got;
        if (got < CHUNK) break;
    }
    std::fclose(f);
    if (skip > 1) return -4;   // truncated final frame
    if (in_hline) {
        const char* h = hline.c_str();
        while (*h == ' ' || *h == '\t' || *h == '\r') ++h;
        if (*h != '\0') return -4;
    }
    return n_frames;
}

// Decode frames [first, first+n_frames): out gets FRACTIONAL coords
// (n_frames*n_atoms*3 f32); numpy applies the cell afterwards.
int fxd_read_block(const char* path, const int64_t* offsets,
                   int64_t n_total_frames, int64_t file_size,
                   int64_t first, int64_t n_frames, int64_t n_atoms,
                   float* out, int n_threads) {
    if (n_frames <= 0) return 0;   // empty slice: never touch offsets
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
            const char* p = buf.data() + (offsets[first + i] - begin_off);
            const char* e = (first + i + 1 < n_total_frames)
                ? buf.data() + (offsets[first + i + 1] - begin_off)
                : buf.data() + span;
            p = next_line(p, e);              // the "Direct" line
            float* fo = out + i * n_atoms * 3;
            for (int64_t a = 0; a < n_atoms; ++a) {
                bool ok = true;
                for (int c = 0; c < 3; ++c)
                    p = parse_float(p, e, fo + a * 3 + c, &ok);
                if (!ok) { err.store(-7); return; }
                p = next_line(p, e);
                if (p >= e && a + 1 < n_atoms) { err.store(-6); return; }
            }
        }
    };
    std::vector<std::thread> threads;
    for (int t = 1; t < n_threads; ++t) threads.emplace_back(work, t);
    work(0);
    for (auto& th : threads) th.join();
    return err.load();
}

}  // extern "C"
