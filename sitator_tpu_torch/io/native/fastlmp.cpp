// fastlmp — multithreaded LAMMPS text-dump trajectory decoder.
//
// Companion to fastxyz.cpp (SURVEY.md §3.9 item 5: native data-loader):
// indexes a LAMMPS `dump atom`/`dump custom` text file once, then decodes
// contiguous frame blocks in parallel.  Cartesian coordinate columns only
// (x y z / xu yu zu); the Python side routes scaled-coordinate dumps to
// its own parser.  C ABI, consumed via ctypes.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>
#include <atomic>

namespace {

inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

inline const char* skip_token(const char* p, const char* end) {
    while (p < end && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r')
        ++p;
    return p;
}

inline const char* next_line(const char* p, const char* end) {
    while (p < end && *p != '\n') ++p;
    return p < end ? p + 1 : end;
}

// Parses a decimal float; *ok is cleared when the token contains no
// digits (nan/inf/corrupt text) so callers can fail loudly instead of
// silently writing 0.0 where the Python parser would surface the value.
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

inline long parse_long(const char* p, const char* end) {
    p = skip_ws(p, end);
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
    long v = 0;
    while (p < end && (unsigned)(*p - '0') < 10u) {
        v = v * 10 + (*p - '0'); ++p;
    }
    return neg ? -v : v;
}

}  // namespace

extern "C" {

// Scan the file; record the byte offset of every "ITEM: TIMESTEP" line.
// Returns the number of frames (may exceed max_frames — call again with a
// larger buffer), or <0 on error.  n_atoms_out: uniform atom count, or -2
// when it varies between frames.
//
// Frame layout: ITEM: TIMESTEP / value / ITEM: NUMBER OF ATOMS / value /
// ITEM: BOX BOUNDS... / 3 bound lines / ITEM: ATOMS ... / n atom lines.
int64_t flmp_index(const char* path, int64_t* offsets, int64_t max_frames,
                   int64_t* n_atoms_out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    const size_t CHUNK = (size_t)1 << 22;
    std::vector<char> buf(CHUNK);
    std::string hline;            // header line carried across chunks
    int64_t n_frames = 0;
    int64_t n_atoms = -1;
    int64_t skip = 0;             // plain lines to swallow
    // header-parse state: 0 = expect "ITEM: TIMESTEP", 1 = reading the
    // NATOMS value line (after its ITEM line was swallowed)
    int state = 0;
    bool in_hline = false;
    int64_t frame_start = 0;
    int64_t base = 0;
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
                if (state == 0) frame_start = base + (p - buf.data());
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
            if (state == 0) {
                const char* h = hline.c_str();
                while (*h == ' ' || *h == '\t' || *h == '\r') ++h;
                if (*h == '\0') continue;          // stray blank line
                if (std::strncmp(h, "ITEM: TIMESTEP", 14) != 0) {
                    std::fclose(f); return -3;     // not a dump file
                }
                if (n_frames < max_frames)
                    offsets[n_frames] = frame_start;
                ++n_frames;
                // swallow: timestep value + "ITEM: NUMBER OF ATOMS"
                skip = 2;
                state = 1;
            } else {
                // this is the NATOMS value line
                long na = std::strtol(hline.c_str(), nullptr, 10);
                if (na <= 0) { std::fclose(f); return -3; }
                if (n_atoms < 0) n_atoms = na;
                else if (n_atoms != na) { std::fclose(f);
                                          *n_atoms_out = -2;
                                          return n_frames; }
                // swallow: BOX BOUNDS item + 3 bounds + ATOMS item + atoms
                skip = 5 + na;
                state = 0;
            }
        }
        base += (int64_t)got;
        if (got < CHUNK) break;
    }
    std::fclose(f);
    if (skip > 1 || state != 0) return -4;         // truncated final frame
    *n_atoms_out = n_atoms;
    return n_frames;
}

// Decode frames [first, first+n_frames) into out (n_frames*n_atoms*3 f32).
// col_id: 0-based index of the atom-id column (-1 = file order);
// col_xyz: 0-based indices of the three cartesian coordinate columns.
// Atom ids must be a permutation of 1..n_atoms per frame (the Python
// wrapper verifies this on frame 0 and falls back otherwise); duplicates
// and out-of-range ids return an error, never silent garbage.
int flmp_read_block(const char* path, const int64_t* offsets,
                    int64_t n_total_frames, int64_t file_size,
                    int64_t first, int64_t n_frames, int64_t n_atoms,
                    int col_id, const int* col_xyz,
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

    int cmax = col_id;
    for (int c = 0; c < 3; ++c) if (col_xyz[c] > cmax) cmax = col_xyz[c];

    if (n_threads < 1) n_threads = 1;
    std::atomic<int> err{0};
    auto work = [&](int t) {
        std::vector<float> vals((size_t)cmax + 1);
        std::vector<uint8_t> seen((size_t)n_atoms);
        for (int64_t i = t; i < n_frames; i += n_threads) {
            const char* p = buf.data() + (offsets[first + i] - begin_off);
            const char* e = (first + i + 1 < n_total_frames)
                ? buf.data() + (offsets[first + i + 1] - begin_off)
                : buf.data() + span;
            for (int h = 0; h < 9; ++h) p = next_line(p, e);  // header
            float* fo = out + i * n_atoms * 3;
            if (col_id >= 0)
                std::memset(seen.data(), 0, (size_t)n_atoms);
            for (int64_t a = 0; a < n_atoms; ++a) {
                // parse tokens up to the max needed column
                const char* q = p;
                long id = 0;
                for (int c = 0; c <= cmax; ++c) {
                    q = skip_ws(q, e);
                    const char* tok = q;
                    q = skip_token(q, e);
                    if (tok == q) { err.store(-4); return; }
                    if (c == col_id) {
                        id = parse_long(tok, q);   // exact integer parse
                    } else if (c == col_xyz[0] || c == col_xyz[1]
                               || c == col_xyz[2]) {
                        float v;
                        bool ok = true;
                        parse_float(tok, q, &v, &ok);
                        if (!ok) { err.store(-7); return; }  // nan/corrupt
                        vals[(size_t)c] = v;
                    }
                }
                int64_t row = a;
                if (col_id >= 0) {
                    if (id < 1 || id > n_atoms) { err.store(-5); return; }
                    if (seen[(size_t)(id - 1)]) { err.store(-5); return; }
                    seen[(size_t)(id - 1)] = 1;
                    row = id - 1;
                }
                fo[row * 3 + 0] = vals[(size_t)col_xyz[0]];
                fo[row * 3 + 1] = vals[(size_t)col_xyz[1]];
                fo[row * 3 + 2] = vals[(size_t)col_xyz[2]];
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
