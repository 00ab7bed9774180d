// Copied from metacache_tpu/native/fastx.cpp; only this header and the
// zlib declarations below differ.
//
// Native FASTA/FASTQ reader + 2-bit encoder + window extractor: the
// counterpart of the reference's C++ I/O stack (sequence_iostream.hpp /
// sequence_io.cpp: buffered gzip-capable record parser;
// query_batch.cuh:85-209: host-side read windowing). The Python layer
// calls these via ctypes; batches land in preallocated NumPy buffers.
//
// Build (metacache_tpu_torch/native/__init__.py does it at first use):
//   g++ -O3 -march=native -shared -fPIC fastx.cpp format.cpp
//       -o libfastx.so -l:libz.so.1
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#if __has_include(<zlib.h>)
#include <zlib.h>
#else
// A host with zlib's shared library but without its header: the six
// functions this reader calls, declared as zlib.h declares them without
// _FILE_OFFSET_BITS=64.
extern "C" {
typedef struct gzFile_s* gzFile;
typedef long z_off_t;
gzFile gzopen(const char* path, const char* mode);
int gzbuffer(gzFile file, unsigned size);
int gzread(gzFile file, void* buf, unsigned len);
int gzdirect(gzFile file);
z_off_t gzseek(gzFile file, z_off_t offset, int whence);
int gzclose(gzFile file);
}
#endif

namespace {

// ASCII -> 2-bit code; 4 = ambiguous (reference: src/dna_encoding.hpp:297-303)
struct CodeTable {
    uint8_t t[256];
    CodeTable() {
        memset(t, 4, sizeof(t));
        t['A'] = t['a'] = 0;
        t['C'] = t['c'] = 1;
        t['G'] = t['g'] = 2;
        t['T'] = t['t'] = 3;
        t['U'] = t['u'] = 3;
    }
};
const CodeTable kCodes;

struct Reader {
    gzFile gz = nullptr;
    std::string buf;      // current line buffer
    size_t pos = 0;       // read position in chunk
    std::string chunk;    // raw chunk buffer
    bool eof = false;
    int peeked = -1;
    int64_t chunk_off = 0;  // absolute file offset of chunk[0]
    int64_t limit = -1;     // stop at first record START >= limit (<0: off)

    int64_t tell() const { return chunk_off + (int64_t)pos; }

    bool fill() {
        if (eof) return false;
        char tmp[1 << 16];
        int n = gzread(gz, tmp, sizeof(tmp));
        if (n <= 0) { eof = true; return false; }
        chunk.append(tmp, n);
        return true;
    }

    // read one line (without newline) into out; returns false at EOF
    bool getline(std::string& out) {
        out.clear();
        for (;;) {
            size_t nl = chunk.find('\n', pos);
            if (nl != std::string::npos) {
                out.append(chunk, pos, nl - pos);
                pos = nl + 1;
                if (pos > (1 << 20)) {
                    chunk_off += (int64_t)pos;
                    chunk.erase(0, pos);
                    pos = 0;
                }
                if (!out.empty() && out.back() == '\r') out.pop_back();
                return true;
            }
            out.append(chunk, pos, chunk.size() - pos);
            chunk_off += (int64_t)chunk.size();
            chunk.clear();
            pos = 0;
            if (!fill()) return !out.empty();
        }
    }

    int peekc() {
        while (pos >= chunk.size()) {
            chunk_off += (int64_t)chunk.size();
            chunk.clear(); pos = 0;
            if (!fill()) return -1;
        }
        return (unsigned char)chunk[pos];
    }

    // at a record boundary: stop once the next record would start at
    // or past `limit` (byte-range partition rule: a record belongs to
    // the range containing its first byte)
    bool past_limit() const { return limit >= 0 && tell() >= limit; }
};

// line [a, b) length without a trailing '\r'
static size_t line_len(const std::string& s, size_t a, size_t b) {
    size_t n = b - a;
    if (n && s[b - 1] == '\r') --n;
    return n;
}

// Advance r->pos to the first record start strictly AFTER the current
// line (used by range opens landing mid-file). FASTA: the next line
// starting with '>'. FASTQ: a line starting with '@' whose +2 line
// starts with '+' and whose +3 line has the +1 line's length (quality
// lines may themselves start with '@'/'+', so the 4-line shape is the
// discriminator). Scans raw buffered bytes only — offsets stay exact.
static bool resync_reader(Reader* r, bool fastq) {
    size_t p = r->chunk.find('\n', r->pos);
    for (;;) {
        while (p == std::string::npos) {
            if (!r->fill()) return false;
            p = r->chunk.find('\n', r->pos);
        }
        size_t ls = p + 1;                       // candidate line start
        while (ls >= r->chunk.size()) {
            if (!r->fill()) return false;
        }
        char c = r->chunk[ls];
        if (!fastq) {
            if (c == '>') { r->pos = ls; return true; }
        } else if (c == '@') {
            // need 4 complete lines from ls
            size_t e[4];
            size_t from = ls;
            bool ok = true;
            for (int i = 0; i < 4; ++i) {
                size_t nl = r->chunk.find('\n', from);
                while (nl == std::string::npos) {
                    if (!r->fill()) { ok = false; break; }
                    nl = r->chunk.find('\n', from);
                }
                if (!ok) break;
                e[i] = nl;
                from = nl + 1;
            }
            if (!ok) return false;               // truncated tail
            size_t l2a = e[0] + 1, l3a = e[1] + 1, l4a = e[2] + 1;
            if (l3a < r->chunk.size() && r->chunk[l3a] == '+' &&
                line_len(r->chunk, l4a, e[3]) ==
                    line_len(r->chunk, l2a, e[1])) {
                r->pos = ls;
                return true;
            }
        }
        p = r->chunk.find('\n', ls);
    }
}

}  // namespace

extern "C" {

void fastx_close(void* h);

void* fastx_open(const char* path) {
    gzFile gz = gzopen(path, "rb");
    if (!gz) return nullptr;
    gzbuffer(gz, 1 << 20);
    Reader* r = new Reader();
    r->gz = gz;
    return r;
}

// Open a byte range [start, end) of an UNCOMPRESSED FASTA/FASTQ file
// (the parallel-reader partition; reference P1's N producer threads,
// src/building.cpp:337-461). A record belongs to the range holding its
// first byte: the reader resyncs to the first record start >= start
// and stops at the first record start >= end. Returns nullptr for
// compressed files with start > 0 (no cheap seek) or on resync
// failure. end < 0 means end-of-file.
void* fastx_open_range(const char* path, int64_t start, int64_t end) {
    gzFile gz = gzopen(path, "rb");
    if (!gz) return nullptr;
    gzbuffer(gz, 1 << 20);
    Reader* r = new Reader();
    r->gz = gz;
    r->limit = end;
    if (start > 0) {
        if (!gzdirect(gz)) { fastx_close(r); return nullptr; }
        // format marker = the file's very first record char
        int c0 = r->peekc();
        bool fastq = (c0 == '@');
        if (gzseek(gz, (z_off_t)(start - 1), SEEK_SET) < 0) {
            fastx_close(r);
            return nullptr;
        }
        r->chunk.clear();
        r->pos = 0;
        r->chunk_off = start - 1;
        r->eof = false;
        if (!resync_reader(r, fastq) || r->past_limit()) {
            // no record starts in [start, end): empty range
            r->chunk.clear();
            r->pos = 0;
            r->eof = true;
        }
    }
    return r;
}

void fastx_close(void* h) {
    Reader* r = (Reader*)h;
    if (r) {
        gzclose(r->gz);
        delete r;
    }
}

// Reads up to max_reads records.
//   codes:   (max_reads, max_len) u8 — 2-bit codes, 4 = ambiguous
//   lens:    (max_reads,) i32 — true length (clamped to max_len in codes)
//   headers: (max_reads, header_cap) char — NUL-terminated, truncated
// Returns number of records read (0 = EOF). Records longer than max_len
// are truncated in `codes` but `lens` holds the full length.
int64_t fastx_read_batch(void* h, int64_t max_reads, int64_t max_len,
                         uint8_t* codes, int32_t* lens,
                         char* headers, int64_t header_cap) {
    Reader* r = (Reader*)h;
    std::string line;
    int64_t n = 0;
    while (n < max_reads) {
        int c = r->peekc();
        if (c < 0) break;
        if (c != '>' && c != '@') {  // malformed line: resync
            r->getline(line);
            continue;
        }
        if (r->past_limit()) break;  // next record belongs to the
                                     // following byte range
        bool fastq = (c == '@');
        r->getline(line);
        // header (skip marker char)
        size_t hl = line.size() > 1 ? line.size() - 1 : 0;
        if ((int64_t)hl >= header_cap) hl = header_cap - 1;
        memcpy(headers + n * header_cap, line.data() + 1, hl);
        headers[n * header_cap + hl] = '\0';

        uint8_t* out = codes + n * max_len;
        int64_t len = 0;
        if (!fastq) {
            for (;;) {
                int p = r->peekc();
                if (p < 0 || p == '>' || p == '@') break;
                r->getline(line);
                for (char ch : line) {
                    if ((unsigned char)ch <= ' ') continue;
                    if (len < max_len) out[len] = kCodes.t[(uint8_t)ch];
                    ++len;
                }
            }
        } else {
            int64_t seqlen = 0;
            for (;;) {
                int p = r->peekc();
                if (p < 0 || p == '+') break;
                r->getline(line);
                for (char ch : line) {
                    if ((unsigned char)ch <= ' ') continue;
                    if (len < max_len) out[len] = kCodes.t[(uint8_t)ch];
                    ++len;
                }
            }
            seqlen = len;
            if (r->peekc() == '+') {
                r->getline(line);  // '+' separator
                int64_t q = 0;
                while (q < seqlen) {  // quality spans lines too
                    if (!r->getline(line)) break;
                    q += (int64_t)line.size();
                }
            }
        }
        // pad the rest of the row with ambiguous
        for (int64_t i = len < max_len ? len : max_len; i < max_len; ++i)
            out[i] = 4;
        lens[n] = (int32_t)len;
        ++n;
    }
    return n;
}

// Summary-fast-path reader: reads up to max_reads records and splits them
// into two streams.
//   clean reads (len <= winlen, no ambiguous character): 2-bit packed,
//     4 bases/byte little-endian within the byte (base 4j in bits 0-1 of
//     byte j) into `packed` (max_reads, ceil(winlen/4)); true length into
//     `plens`. This is exactly the device infeed consumed by
//     query_step_rows_scan(infeed_packed=True) — zero host transforms.
//   everything else (long reads, reads with N): unpacked codes into the
//     side buffer `scodes` (side_cap, side_max_len) + `slens` +
//     NUL-terminated `sheaders`, for the generic per-batch path.
// Stops early when either stream fills. Returns records consumed;
// *out_npacked / *out_nside give the per-stream counts.
int64_t fastx_read_packed(void* h, int64_t max_reads, int32_t winlen,
                          uint8_t* packed, int32_t* plens,
                          int64_t side_cap, int64_t side_max_len,
                          uint8_t* scodes, int32_t* slens,
                          char* sheaders, int64_t header_cap,
                          int64_t* out_npacked, int64_t* out_nside) {
    Reader* r = (Reader*)h;
    const int64_t pstride = (winlen + 3) / 4;
    std::string line;
    std::string tmp;          // decoded codes of the current record
    int64_t np = 0, ns = 0, consumed = 0;
    while (np < max_reads && ns < side_cap) {
        int c = r->peekc();
        if (c < 0) break;
        if (c != '>' && c != '@') { r->getline(line); continue; }
        if (r->past_limit()) break;
        bool fastq = (c == '@');
        r->getline(line);
        size_t hl = line.size() > 1 ? line.size() - 1 : 0;
        if ((int64_t)hl >= header_cap) hl = header_cap - 1;
        // headers are only kept for side-buffer reads; stash a copy
        std::string hdr(line.data() + (line.empty() ? 0 : 1), hl);

        tmp.clear();
        bool has_n = false;
        if (!fastq) {
            for (;;) {
                int p = r->peekc();
                if (p < 0 || p == '>' || p == '@') break;
                r->getline(line);
                for (char ch : line) {
                    if ((unsigned char)ch <= ' ') continue;
                    uint8_t code = kCodes.t[(uint8_t)ch];
                    has_n |= (code >= 4);
                    tmp.push_back((char)code);
                }
            }
        } else {
            for (;;) {
                int p = r->peekc();
                if (p < 0 || p == '+') break;
                r->getline(line);
                for (char ch : line) {
                    if ((unsigned char)ch <= ' ') continue;
                    uint8_t code = kCodes.t[(uint8_t)ch];
                    has_n |= (code >= 4);
                    tmp.push_back((char)code);
                }
            }
            if (r->peekc() == '+') {
                r->getline(line);
                int64_t q = 0;
                while (q < (int64_t)tmp.size()) {
                    if (!r->getline(line)) break;
                    q += (int64_t)line.size();
                }
            }
        }
        int64_t len = (int64_t)tmp.size();
        ++consumed;
        if (!has_n && len <= winlen) {
            uint8_t* out = packed + np * pstride;
            memset(out, 0, pstride);
            for (int64_t i = 0; i < len; ++i)
                out[i >> 2] |= (uint8_t)(tmp[i] << ((i & 3) * 2));
            plens[np] = (int32_t)len;
            ++np;
        } else {
            uint8_t* out = scodes + ns * side_max_len;
            int64_t keep = len < side_max_len ? len : side_max_len;
            memcpy(out, tmp.data(), keep);
            memset(out + keep, 4, side_max_len - keep);
            slens[ns] = (int32_t)len;
            size_t copy = hdr.size();
            if ((int64_t)copy >= header_cap) copy = header_cap - 1;
            memcpy(sheaders + ns * header_cap, hdr.data(), copy);
            sheaders[ns * header_cap + copy] = '\0';
            ++ns;
        }
    }
    *out_npacked = np;
    *out_nside = ns;
    return consumed;
}

// One-pass scan: record count and maximum sequence length (used to decide
// whether the fixed-width batch reader can represent a file exactly).
void fastx_scan(const char* path, int64_t* out_count, int64_t* out_maxlen) {
    *out_count = 0;
    *out_maxlen = 0;
    gzFile gz = gzopen(path, "rb");
    if (!gz) return;
    gzbuffer(gz, 1 << 20);
    Reader r;
    r.gz = gz;
    std::string line;
    int64_t len = 0;
    bool in_seq = false, fastq = false, in_qual = false;
    int64_t qual = 0;
    while (r.getline(line)) {
        if (!in_qual && !line.empty() &&
            (line[0] == '>' || line[0] == '@')) {
            if (in_seq) {
                if (len > *out_maxlen) *out_maxlen = len;
                ++*out_count;
            }
            in_seq = true;
            fastq = (line[0] == '@');
            len = 0;
            continue;
        }
        if (fastq && !in_qual && !line.empty() && line[0] == '+') {
            in_qual = true;
            qual = 0;
            continue;
        }
        if (in_qual) {
            qual += (int64_t)line.size();
            if (qual >= len) in_qual = false;
            continue;
        }
        for (char ch : line)
            if ((unsigned char)ch > ' ') ++len;
    }
    if (in_seq) {
        if (len > *out_maxlen) *out_maxlen = len;
        ++*out_count;
    }
    gzclose(gz);
}

// Encode a raw ASCII buffer to 2-bit codes (vector path for target
// genomes loaded via Python).
void encode_ascii(const uint8_t* in, int64_t n, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) out[i] = kCodes.t[in[i]];
}

// Extract windows from a batch of coded reads.
//   codes (num_reads, max_len), lens (num_reads,)
//   windows (cap_windows, winlen) u8 pre-filled by caller or padded here
//   valid (cap_windows,) i32, qid (cap_windows,) i32
// Window semantics mirror for_each_window (src/hash_dna.hpp:54-90):
// offsets 0, stride, ... while off+winlen <= len, plus a trailing partial;
// windows shorter than kmerlen are skipped. Returns total windows written
// (stops early at cap_windows; check return < cap).
int64_t extract_windows(const uint8_t* codes, const int32_t* lens,
                        int64_t num_reads, int64_t max_len,
                        int32_t winlen, int32_t stride, int32_t kmerlen,
                        uint8_t* windows, int32_t* valid, int32_t* qid,
                        int64_t cap_windows) {
    int64_t w = 0;
    for (int64_t i = 0; i < num_reads; ++i) {
        int64_t len = lens[i];
        if (len > max_len) len = max_len;
        const uint8_t* src = codes + i * max_len;
        int64_t off = 0;
        if (len <= winlen) {
            if (len >= kmerlen && w < cap_windows) {
                memcpy(windows + w * winlen, src, len);
                memset(windows + w * winlen + len, 4, winlen - len);
                valid[w] = (int32_t)len;
                qid[w] = (int32_t)i;
                ++w;
            }
            continue;
        }
        for (off = 0; off + winlen <= len; off += stride) {
            if (w >= cap_windows) return w;
            memcpy(windows + w * winlen, src + off, winlen);
            valid[w] = winlen;
            qid[w] = (int32_t)i;
            ++w;
        }
        if (off < len && len - off >= kmerlen) {
            if (w >= cap_windows) return w;
            int64_t rem = len - off;
            memcpy(windows + w * winlen, src + off, rem);
            memset(windows + w * winlen + rem, 4, winlen - rem);
            valid[w] = (int32_t)rem;
            qid[w] = (int32_t)i;
            ++w;
        }
    }
    return w;
}

}  // extern "C"
