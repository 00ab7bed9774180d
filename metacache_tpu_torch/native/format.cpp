// Copied from metacache_tpu/native/format.cpp.
//
// Native per-read mapping-line formatter.
//
// The per-read output path (-tophits and friends) was bound by Python
// string assembly (~27 us/read in classify/runner._postprocess_arrays).
// Here the host prep resolves every taxon/candidate to an index into a
// memoized string table (a metagenomic run touches a few thousand
// distinct taxa across millions of reads), and this function emits the
// final bytes — the same strings MappingLineWriter.line() would build
// (reference: show_query_mapping, src/classification.cpp:470-533; the
// reference pays the formatting cost per read on 128 threads, we batch
// it through one memcpy-bound loop instead).
//
// Contract (mirrors classify/output.MappingLineWriter.line):
//   [qid sep] header_token sep [tophits sep] best_str "\n"
// where tophits = ",".join(prefix ":" hits | prefix-only entries).
#include <cstdint>
#include <cstring>

namespace {

inline uint8_t* put_u64(uint8_t* p, uint64_t v) {
    char tmp[20];
    int i = 0;
    do { tmp[i++] = char('0' + v % 10); v /= 10; } while (v);
    while (i) *p++ = uint8_t(tmp[--i]);
    return p;
}

inline uint8_t* put_i32(uint8_t* p, int32_t v) {
    if (v < 0) { *p++ = '-'; return put_u64(p, uint64_t(-(int64_t)v)); }
    return put_u64(p, uint64_t(v));
}

} // namespace

extern "C" {

// Returns bytes written. The caller guarantees `cap` is a safe upper
// bound (it knows the max table-string and header widths); on overflow
// risk the function stops early and returns -1 (caller falls back).
int64_t format_map_lines(
    const uint8_t* headers, int64_t n, int64_t hcap,
    int64_t qid0,                 // first query id; < 0 => no qid column
    const int32_t* best_sidx,     // (n,) string idx of final column
    const uint8_t* skip,          // (n,) 1 => suppress whole line
    const int32_t* cand_sidx,     // (n*k,) tophits prefix idx, -1 = stop
    const uint8_t* cand_flag,     // (n*k,) 1 => entry is prefix only
    const int32_t* cand_hits,     // (n*k,)
    int32_t k, int32_t show_tophits,
    const uint8_t* strtab, const int64_t* stroff,
    const uint8_t* sep, int64_t sep_len,
    uint8_t* out, int64_t cap, int64_t line_bound)
{
    uint8_t* p = out;
    // line_bound = the caller's worst-case bytes for ONE line (it also
    // sizes `out` as n * line_bound + slack); checked per line so a
    // miscomputed bound degrades to a clean fallback, never a write
    // past `out + cap`.
    for (int64_t i = 0; i < n; ++i) {
        if (skip && skip[i]) continue;
        if (p - out > cap - line_bound)
            return -1;  // caller's bound was too small: fall back
        if (qid0 >= 0) {
            p = put_u64(p, uint64_t(qid0 + i));
            std::memcpy(p, sep, sep_len); p += sep_len;
        }
        const uint8_t* h = headers + i * hcap;
        int64_t j = 0;
        while (j < hcap && h[j] && h[j] != ' ') ++j;
        std::memcpy(p, h, j); p += j;
        std::memcpy(p, sep, sep_len); p += sep_len;
        if (show_tophits) {
            const int32_t* cs = cand_sidx + i * k;
            const uint8_t* cf = cand_flag + i * k;
            const int32_t* ch = cand_hits + i * k;
            for (int32_t c = 0; c < k; ++c) {
                int32_t s = cs[c];
                if (s < 0) break;
                if (c) *p++ = ',';
                int64_t off = stroff[s], len = stroff[s + 1] - off;
                std::memcpy(p, strtab + off, len); p += len;
                if (!cf[c]) {
                    *p++ = ':';
                    p = put_i32(p, ch[c]);
                }
            }
            std::memcpy(p, sep, sep_len); p += sep_len;
        }
        {
            int32_t s = best_sidx[i];
            int64_t off = stroff[s], len = stroff[s + 1] - off;
            std::memcpy(p, strtab + off, len); p += len;
        }
        *p++ = '\n';
    }
    return p - out;
}

} // extern "C"
