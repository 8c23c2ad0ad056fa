// Native string kernels for dictionary-table evaluation.
//
// Role: the reference's string hot path is native-tier JVM code
// (common/unsafe/.../types/UTF8String.java byte-level contains/match,
// plus Janino-codegen'd LIKE, catalyst
// expressions/regexpExpressions.scala). In this engine every string
// predicate evaluates host-side over a column's *dictionary* (strings
// never materialize on device), so the hot loop is "run one predicate
// over millions of distinct UTF-8 strings". CPython regex/str calls pay
// object overhead per entry; these kernels stream over the Arrow
// buffer (int64 offsets + contiguous UTF-8 bytes) directly.
//
// The port's copy of spark_tpu/native/strkernels.cpp (like_table and
// predicate_table). Semantics mirror expr/compiler.py exactly:
//   LIKE: '%' = any byte sequence, '_' = exactly one CODEPOINT
//         (the Python path uses re '.' with DOTALL), all other
//         pattern chars are literal (no escape syntax).
//
// Built by spark_tpu_torch/native/__init__.py with g++ -O3 at first use
// (ops/_build.py) and loaded via ctypes; a failed build raises.

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

// Advance one UTF-8 codepoint starting at s[i]; returns new index.
static inline int64_t utf8_next(const char* s, int64_t i, int64_t len) {
    unsigned char c = static_cast<unsigned char>(s[i]);
    int64_t step = 1;
    if (c >= 0xF0) step = 4;
    else if (c >= 0xE0) step = 3;
    else if (c >= 0xC0) step = 2;
    i += step;
    return i > len ? len : i;
}

// Iterative greedy wildcard match with backtracking on the last '%'.
static bool like_one(const char* s, int64_t slen,
                     const char* p, int64_t plen) {
    int64_t si = 0, pi = 0;
    int64_t star_pi = -1, star_si = 0;
    while (si < slen) {
        if (pi < plen && p[pi] == '%') {
            star_pi = ++pi;
            star_si = si;
        } else if (pi < plen && p[pi] == '_') {
            si = utf8_next(s, si, slen);
            ++pi;
        } else if (pi < plen && p[pi] == s[si]) {
            ++si;
            ++pi;
        } else if (star_pi >= 0) {
            star_si = utf8_next(s, star_si, slen);
            si = star_si;
            pi = star_pi;
        } else {
            return false;
        }
    }
    while (pi < plen && p[pi] == '%') ++pi;
    return pi == plen;
}

// data/offsets: Arrow large_string layout; out: one byte per entry.
void like_table(const char* data, const int64_t* offsets, int64_t n,
                const char* pattern, int64_t plen, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const char* s = data + offsets[i];
        int64_t slen = offsets[i + 1] - offsets[i];
        out[i] = like_one(s, slen, pattern, plen) ? 1 : 0;
    }
}

// op: 0 = contains, 1 = startswith, 2 = endswith
void predicate_table(const char* data, const int64_t* offsets, int64_t n,
                     const char* needle, int64_t nlen, int32_t op,
                     uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const char* s = data + offsets[i];
        int64_t slen = offsets[i + 1] - offsets[i];
        bool r;
        if (nlen > slen) {
            r = false;
        } else if (op == 1) {
            r = std::memcmp(s, needle, nlen) == 0;
        } else if (op == 2) {
            r = std::memcmp(s + slen - nlen, needle, nlen) == 0;
        } else {
            r = nlen == 0 ||
                std::search(s, s + slen, needle, needle + nlen) != s + slen;
        }
        out[i] = r ? 1 : 0;
    }
}

}  // extern "C"
