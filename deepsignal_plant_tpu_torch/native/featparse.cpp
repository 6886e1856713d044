// Native host codecs of the features-TSV plane of call_mods (the port's
// own copy of the parts of deepsignal_plant_tpu/native/featparse.cpp that
// this package calls; the rest is left for the slices that need it), and
// the call_mods row parser of call_freq.
//
// The features format (12 tab-separated columns, reference
// extract_features.py:381-395) carries ~260 floats per row; parsing it in
// Python binds the call_mods feed. These functions walk the raw byte
// buffer once and fill caller-allocated numpy arrays. Built by
// native/__init__.py with g++ at first use; bound with ctypes
// (utils/fastparse.py).
//
// C ABI:
//   dsp_count_lines(buf, len) -> newline count (+1 for an unterminated
//     final line).
//   dsp_parse_features / dsp_parse_features_f16(buf, len, kmer_len,
//     signal_len, kmer, means, stds, slens, signals, labels, row_starts,
//     info_ends) -> rows parsed, or -(line_index+1) on a malformed line.
//     The f16 variant writes the float16 wire (int8 codes, IEEE halves).
//   dsp_parse_calls(buf, len, ...) -> call_mods rows parsed into per-row
//     arrays with interned chromosome names, -(line+1) on a malformed
//     line, INT64_MIN when the name table overflows.
//   dsp_emit_call_rows(...) -> bytes of complete call_mods rows.
//   dsp_format_call_suffixes(...) -> bytes of "\tP0\tP1\tLABEL\tKMER5\n"
//     suffixes.
//   dsp_pack_rows(...) -> bases of the read-packed wire, or -(row+1).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string_view>
#include <unordered_map>

namespace {

// base -> code table (reference process_utils.py:25-28)
int8_t base_code(char c) {
    switch (c) {
        case 'A': return 0; case 'C': return 1; case 'G': return 2;
        case 'T': return 3; case 'N': return 4; case 'W': return 5;
        case 'S': return 6; case 'M': return 7; case 'K': return 8;
        case 'R': return 9; case 'Y': return 10; case 'B': return 11;
        case 'V': return 12; case 'D': return 13; case 'H': return 14;
        case 'Z': return 15; default: return 4;  // unknown -> N
    }
}

// fast float parse for our constrained grammar: [-]ddd[.ffffff][e[+-]dd]
// falls back to strtod for anything unusual.
inline double parse_float(const char*& p, const char* end, bool& ok) {
    const char* start = p;
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
    uint64_t ip = 0; int idig = 0;
    while (p < end && *p >= '0' && *p <= '9') {
        ip = ip * 10 + uint64_t(*p - '0'); ++p; ++idig;
    }
    double val = double(ip);
    if (p < end && *p == '.') {
        ++p;
        uint64_t fp = 0; int fdig = 0;
        while (p < end && *p >= '0' && *p <= '9') {
            fp = fp * 10 + uint64_t(*p - '0'); ++p; ++fdig;
        }
        static const double kPow10[19] = {
            1e0, 1e-1, 1e-2, 1e-3, 1e-4, 1e-5, 1e-6, 1e-7, 1e-8, 1e-9,
            1e-10, 1e-11, 1e-12, 1e-13, 1e-14, 1e-15, 1e-16, 1e-17, 1e-18};
        if (fdig < 19 && idig + fdig < 19) {
            val += double(fp) * kPow10[fdig];
        } else {
            char* e2 = nullptr;
            val = strtod(start, &e2);
            p = e2;
            ok = (p != start);
            return val;
        }
    }
    if (p < end && (*p == 'e' || *p == 'E')) {  // rare: scientific notation
        char* e2 = nullptr;
        val = strtod(start, &e2);
        p = e2;
        ok = (p != start);
        return val;
    }
    ok = (idig > 0);
    return neg ? -val : val;
}

}  // namespace

extern "C" {

int64_t dsp_count_lines(const char* buf, int64_t len) {
    int64_t n = 0;
    const char* p = buf;
    const char* end = buf + len;
    while ((p = static_cast<const char*>(memchr(p, '\n', end - p)))) {
        ++n; ++p;
    }
    if (len > 0 && buf[len - 1] != '\n') ++n;  // unterminated final line
    return n;
}

}  // extern "C"

namespace {

// templated core so one parser emits float32 (KT=int32 kmer codes) or the
// model's exact wire format (FT=_Float16, KT=int8) with no Python-side
// astype pass over ~260 values/row
template <typename FT, typename KT>
int64_t parse_features_impl(const char* buf, int64_t len, int kmer_len,
                            int signal_len, KT* kmer, FT* means,
                            FT* stds, FT* slens, FT* signals,
                            int32_t* labels, int64_t* row_starts,
                            int64_t* info_ends) {
    const char* p = buf;
    const char* end = buf + len;
    int64_t row = 0;
    const int L = kmer_len;
    const int S = signal_len;

    while (p < end) {
        const char* line_start = p;
        const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
        const char* line_end = nl ? nl : end;
        if (line_start == line_end) { p = line_end + 1; continue; }
        row_starts[row] = line_start - buf;

        // skip the 6 passthrough text columns
        const char* q = line_start;
        for (int t = 0; t < 6; ++t) {
            q = static_cast<const char*>(memchr(q, '\t', line_end - q));
            if (!q) return -(row + 1);
            ++q;
        }
        info_ends[row] = (q - 1) - buf;

        // col 6: kmer
        KT* krow = kmer + row * L;
        for (int i = 0; i < L; ++i) {
            if (q >= line_end || *q == '\t') return -(row + 1);
            krow[i] = base_code(*q++);
        }
        if (q >= line_end || *q != '\t') return -(row + 1);
        ++q;

        bool ok = true;
        // cols 7-9: csv float vectors of length L
        FT* vecs[3] = {means + row * L, stds + row * L, slens + row * L};
        for (int v = 0; v < 3; ++v) {
            FT* out = vecs[v];
            for (int i = 0; i < L; ++i) {
                out[i] = FT(parse_float(q, line_end, ok));
                if (!ok) return -(row + 1);
                if (i + 1 < L) {
                    if (q >= line_end || *q != ',') return -(row + 1);
                    ++q;
                }
            }
            if (q >= line_end || *q != '\t') return -(row + 1);
            ++q;
        }
        // col 10: L rows of S csv floats joined by ';'
        FT* srow = signals + row * int64_t(L) * S;
        for (int i = 0; i < L; ++i) {
            for (int j = 0; j < S; ++j) {
                srow[i * S + j] = FT(parse_float(q, line_end, ok));
                if (!ok) return -(row + 1);
                if (j + 1 < S) {
                    if (q >= line_end || *q != ',') return -(row + 1);
                    ++q;
                }
            }
            if (i + 1 < L) {
                if (q >= line_end || *q != ';') return -(row + 1);
                ++q;
            }
        }
        if (q >= line_end || *q != '\t') return -(row + 1);
        ++q;
        // col 11: label
        bool lneg = false;
        if (q < line_end && *q == '-') { lneg = true; ++q; }
        int32_t lab = 0;
        bool ldig = false;
        while (q < line_end && *q >= '0' && *q <= '9') {
            lab = lab * 10 + (*q - '0'); ++q; ldig = true;
        }
        if (!ldig) return -(row + 1);
        // allow trailing \r
        labels[row] = lneg ? -lab : lab;

        ++row;
        p = line_end + 1;
    }
    return row;
}

}  // namespace

extern "C" {

int64_t dsp_parse_features(const char* buf, int64_t len, int kmer_len,
                           int signal_len, int32_t* kmer, float* means,
                           float* stds, float* slens, float* signals,
                           int32_t* labels, int64_t* row_starts,
                           int64_t* info_ends) {
    return parse_features_impl<float, int32_t>(
        buf, len, kmer_len, signal_len, kmer, means, stds, slens, signals,
        labels, row_starts, info_ends);
}

// wire-format output: float16 feature values (uint16 bit pattern) and
// int8 base codes — exactly what the f16 transfer path sends to the TPU
int64_t dsp_parse_features_f16(const char* buf, int64_t len, int kmer_len,
                               int signal_len, int8_t* kmer,
                               uint16_t* means, uint16_t* stds,
                               uint16_t* slens, uint16_t* signals,
                               int32_t* labels, int64_t* row_starts,
                               int64_t* info_ends) {
    return parse_features_impl<_Float16, int8_t>(
        buf, len, kmer_len, signal_len, kmer,
        reinterpret_cast<_Float16*>(means),
        reinterpret_cast<_Float16*>(stds),
        reinterpret_cast<_Float16*>(slens),
        reinterpret_cast<_Float16*>(signals),
        labels, row_starts, info_ends);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// call_mods row parsing (the call_freq aggregation input)
// ---------------------------------------------------------------------------
//
// A call_mods row has 10 tab-separated columns (reference
// call_modifications.py:176-188 emission, consumed by
// call_mods_freq.py:41-59):
//   chrom  pos  strand  pos_in_strand  readname  read_strand  p0  p1
//   called_label  kmer
// This parser fills per-row numeric arrays and interns chromosome names
// into a per-call table: chrom_ids[i] indexes the '\n'-joined names
// written to chrom_buf (n_chroms_out entries). kmer strings stay in the
// input buffer; kmer_off/kmer_len point at them.
//
// Returns rows parsed, -(line+1) on a malformed line, or INT64_MIN when
// chrom_buf_cap is too small.

namespace {

inline int64_t parse_int(const char*& p, const char* end, bool& ok) {
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
    uint64_t v = 0;
    int dig = 0;
    while (p < end && *p >= '0' && *p <= '9') {
        v = v * 10 + uint64_t(*p - '0'); ++p; ++dig;
    }
    ok = dig > 0;
    return neg ? -int64_t(v) : int64_t(v);
}

}  // namespace

extern "C" {

int64_t dsp_parse_calls(const char* buf, int64_t len, int32_t* chrom_ids,
                        int64_t* pos, uint8_t* strand,
                        int64_t* pos_in_strand, double* p0, double* p1,
                        int32_t* label, int64_t* kmer_off,
                        int32_t* kmer_len, char* chrom_buf,
                        int64_t chrom_buf_cap, int32_t* n_chroms_out) {
    const char* p = buf;
    const char* end = buf + len;
    int64_t row = 0;
    std::unordered_map<std::string_view, int32_t> interned;
    char* cb = chrom_buf;
    char* cb_end = chrom_buf + chrom_buf_cap;
    std::string_view last_chrom;
    int32_t last_id = -1;

    while (p < end) {
        const char* line_end =
            static_cast<const char*>(memchr(p, '\n', end - p));
        if (!line_end) line_end = end;
        if (p == line_end) { p = line_end + 1; continue; }
        const char* le = line_end;
        if (le > p && le[-1] == '\r') --le;

        // col 0: chrom (interned)
        const char* tab = static_cast<const char*>(memchr(p, '\t', le - p));
        if (!tab) return -(row + 1);
        std::string_view chrom(p, size_t(tab - p));
        if (chrom == last_chrom && last_id >= 0) {
            chrom_ids[row] = last_id;
        } else {
            auto it = interned.find(chrom);
            int32_t id;
            if (it != interned.end()) {
                id = it->second;
            } else {
                id = int32_t(interned.size());
                if (cb + chrom.size() + 1 > cb_end) return INT64_MIN;
                memcpy(cb, chrom.data(), chrom.size());
                cb += chrom.size();
                *cb++ = '\n';
                interned.emplace(chrom, id);
            }
            chrom_ids[row] = id;
            last_chrom = chrom;
            last_id = id;
        }
        const char* q = tab + 1;

        bool ok = true;
        // col 1: pos
        pos[row] = parse_int(q, le, ok);
        if (!ok || q >= le || *q != '\t') return -(row + 1);
        ++q;
        // col 2: strand (single char)
        strand[row] = uint8_t(*q++);
        if (q >= le || *q != '\t') return -(row + 1);
        ++q;
        // col 3: pos_in_strand (may be -1)
        pos_in_strand[row] = parse_int(q, le, ok);
        if (!ok || q >= le || *q != '\t') return -(row + 1);
        ++q;
        // cols 4-5: readname, read_strand (skipped)
        for (int t = 0; t < 2; ++t) {
            q = static_cast<const char*>(memchr(q, '\t', le - q));
            if (!q) return -(row + 1);
            ++q;
        }
        // cols 6-7: p0, p1
        p0[row] = parse_float(q, le, ok);
        if (!ok || q >= le || *q != '\t') return -(row + 1);
        ++q;
        p1[row] = parse_float(q, le, ok);
        if (!ok || q >= le || *q != '\t') return -(row + 1);
        ++q;
        // col 8: called label
        label[row] = int32_t(parse_int(q, le, ok));
        if (!ok || q >= le || *q != '\t') return -(row + 1);
        ++q;
        // col 9: kmer (to end of line)
        kmer_off[row] = q - buf;
        kmer_len[row] = int32_t(le - q);
        ++row;
        p = line_end + 1;
    }
    *n_chroms_out = int32_t(interned.size());
    return row;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// call_mods row-suffix formatting
// ---------------------------------------------------------------------------
//
// Produces, per row, the text "\tP0\tP1\tLABEL\tKMER5\n" where P0 is
// p0/(p0+p1) rounded to 6 decimals and P1 = 1 - P0 (reference
// call_modifications.py:176-188). The probability strings are the minimal
// decimal representation of the rounded value (matching Python's
// str(round(x, 6)) except at sub-ulp .5e-6 boundaries).

namespace {

const char kBases[17] = "ACGTNWSMKRYBVDHZ";

// Python repr of x = a/1e6 for 0 < a < 100 (|x| < 1e-4): scientific
// notation, e.g. 41 -> "4.1e-05", 40 -> "4e-05", 5 -> "5e-06".
char* write_small_sci(char* p, unsigned long long a) {
    if (a >= 10) {
        *p++ = char('0' + a / 10);
        if (a % 10) { *p++ = '.'; *p++ = char('0' + a % 10); }
        *p++ = 'e'; *p++ = '-'; *p++ = '0'; *p++ = '5';
    } else {
        *p++ = char('0' + a);
        *p++ = 'e'; *p++ = '-'; *p++ = '0'; *p++ = '6';
    }
    return p;
}

// write r/1e6 (0 <= r <= 1e6) as Python str(round(x, 6)):
// 123450 -> 0.12345, 500000 -> 0.5, 0 -> 0.0, 1000000 -> 1.0,
// 41 -> 4.1e-05 (repr switches to scientific below 1e-4)
char* write_prob(char* p, int64_t r) {
    if (r > 0 && r < 100) return write_small_sci(p, (unsigned long long)r);
    *p++ = (r >= 1000000) ? '1' : '0';
    if (r >= 1000000) r -= 1000000;
    *p++ = '.';
    if (r == 0) { *p++ = '0'; return p; }
    char digits[6];
    for (int i = 5; i >= 0; --i) { digits[i] = char('0' + r % 10); r /= 10; }
    int last = 5;
    while (last > 0 && digits[last] == '0') --last;
    for (int i = 0; i <= last; ++i) *p++ = digits[i];
    return p;
}

// round v*1e6 half-even
int64_t round6(double v) {
    double t = v * 1e6;
    double f = floor(t);
    double frac = t - f;
    int64_t r = int64_t(f);
    if (frac > 0.5) ++r;
    else if (frac == 0.5 && (r & 1)) ++r;
    return r;
}

}  // namespace

extern "C" {

// Zero-Python-strings emission: writes complete call_mods rows —
// the untouched input info prefix (cols 0-5, sliced straight from the
// features byte block via row_starts/info_ends) followed by the computed
// "\tp0\tp1\tlabel\tkmer5\n" suffix. kmer: int8 codes (the f16 wire
// layout). out must hold sum(info lengths) + n*40 bytes. Returns total
// bytes written.
int64_t dsp_emit_call_rows(const char* buf, const int64_t* row_starts,
                           const int64_t* info_ends, const float* probs,
                           const int8_t* kmer, int64_t n, int kmer_len,
                           char* out) {
    char* p = out;
    int center = kmer_len / 2;
    int lo = center - 2 > 0 ? center - 2 : 0;
    int hi = center + 3 < kmer_len ? center + 3 : kmer_len;
    for (int64_t i = 0; i < n; ++i) {
        size_t ilen = size_t(info_ends[i] - row_starts[i]);
        memcpy(p, buf + row_starts[i], ilen);
        p += ilen;
        double p0 = probs[2 * i];
        double p1 = probs[2 * i + 1];
        int64_t r0 = round6(p0 / (p0 + p1));
        int64_t r1 = 1000000 - r0;
        *p++ = '\t';
        p = write_prob(p, r0);
        *p++ = '\t';
        p = write_prob(p, r1);
        *p++ = '\t';
        *p++ = (p0 >= p1) ? '0' : '1';
        *p++ = '\t';
        const int8_t* k = kmer + i * kmer_len;
        for (int j = lo; j < hi; ++j) {
            int8_t c = k[j];
            *p++ = (c >= 0 && c < 16) ? kBases[c] : 'N';
        }
        *p++ = '\n';
    }
    return p - out;
}

// probs: (n, 2) float32; kmer: (n, L) int32; out: buffer of >= n*40 bytes.
// Writes n suffix lines "\tp0\tp1\tlabel\tkmer5\n"; fills out_lens[i] with
// each line's byte length. Returns total bytes written.
int64_t dsp_format_call_suffixes(const float* probs, const int32_t* kmer,
                                 int64_t n, int kmer_len, char* out,
                                 int32_t* out_lens) {
    char* p = out;
    int center = kmer_len / 2;
    int lo = center - 2 > 0 ? center - 2 : 0;
    int hi = center + 3 < kmer_len ? center + 3 : kmer_len;
    for (int64_t i = 0; i < n; ++i) {
        char* start = p;
        double p0 = probs[2 * i];
        double p1 = probs[2 * i + 1];
        int64_t r0 = round6(p0 / (p0 + p1));
        int64_t r1 = 1000000 - r0;
        *p++ = '\t';
        p = write_prob(p, r0);
        *p++ = '\t';
        p = write_prob(p, r1);
        *p++ = '\t';
        *p++ = (p0 >= p1) ? '0' : '1';
        *p++ = '\t';
        const int32_t* k = kmer + i * kmer_len;
        for (int j = lo; j < hi; ++j) {
            int32_t c = k[j];
            *p++ = (c >= 0 && c < 16) ? kBases[c] : 'N';
        }
        *p++ = '\n';
        out_lens[i] = int32_t(p - start);
    }
    return p - out;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// read-packed repacking of parsed per-site rows (the TSV -> packed-wire
// bridge). Consecutive rows of one read carry overlapping kmer windows
// (adjacent motif sites share L-1 of their L window bases); this pass
// rebuilds the deduplicated per-base arrays + int32 window centers the
// packed device step consumes. Dedup is CONSERVATIVE: a row joins the
// previous row's run only when its identity columns (chrom, strand,
// readname, read_strand) match, |pos delta| < L, and every overlapping
// window byte (kmer, means, stds, slens, signals) is identical —
// otherwise it starts a fresh L-base segment, which is always correct
// (just not deduplicated). Any row order (sorted, shuffled, multi-read
// interleaved) therefore yields byte-identical downstream output.
// ---------------------------------------------------------------------------

namespace {

// tokenize the 6 passthrough cols of one info span; returns false on
// malformed input. tok[k]/tlen[k] cover cols 0..5.
inline bool split_info(const char* s, const char* e, const char** tok,
                       int64_t* tlen) {
    for (int k = 0; k < 6; ++k) {
        tok[k] = s;
        const char* t = (k < 5)
            ? static_cast<const char*>(memchr(s, '\t', e - s)) : e;
        if (!t) return false;
        tlen[k] = t - s;
        s = t + 1;
    }
    return true;
}

inline bool tok_eq(const char* a, int64_t alen, const char* b,
                   int64_t blen) {
    return alen == blen && memcmp(a, b, size_t(alen)) == 0;
}

}  // namespace

extern "C" {

// Returns the packed base count (>= 0), or -(row+1) on a malformed info
// span. Output capacities: codes/means/stds/lens n*L elements, rect
// n*L*S, centers n.
int64_t dsp_pack_rows(const char* buf, const int64_t* row_starts,
                      const int64_t* info_ends, const int8_t* kmer,
                      const uint16_t* means, const uint16_t* stds,
                      const uint16_t* slens, const uint16_t* signals,
                      int64_t n, int32_t L, int32_t S, int8_t* codes_out,
                      uint16_t* means_out, uint16_t* stds_out,
                      uint16_t* lens_out, uint16_t* rect_out,
                      int32_t* centers_out) {
    const int nb = (L - 1) / 2;
    int64_t off = 0;           // bases written
    int64_t prev_center = -1;  // previous row's center (output axis)
    int64_t prev_pos = 0;
    const char* ptok[6] = {};
    int64_t plen[6] = {0, 0, 0, 0, 0, 0};
    bool have_prev = false;

    for (int64_t r = 0; r < n; ++r) {
        const char* s = buf + row_starts[r];
        const char* e = buf + info_ends[r];
        const char* tok[6];
        int64_t tlen[6];
        if (!split_info(s, e, tok, tlen)) return -(r + 1);
        // col 1: pos (non-negative integer)
        int64_t pos = 0;
        bool dig = false;
        for (const char* q = tok[1]; q < tok[1] + tlen[1]; ++q) {
            if (*q < '0' || *q > '9') { dig = false; break; }
            pos = pos * 10 + (*q - '0');
            dig = true;
        }
        if (!dig) return -(r + 1);

        const int8_t* krow = kmer + r * L;
        const uint16_t* mrow = means + r * L;
        const uint16_t* drow = stds + r * L;
        const uint16_t* lrow = slens + r * L;
        const uint16_t* srow = signals + r * int64_t(L) * S;

        int64_t shift = -1;
        if (have_prev && tok_eq(tok[0], tlen[0], ptok[0], plen[0]) &&
            tok_eq(tok[2], tlen[2], ptok[2], plen[2]) &&
            tok_eq(tok[4], tlen[4], ptok[4], plen[4]) &&
            tok_eq(tok[5], tlen[5], ptok[5], plen[5])) {
            int64_t d = pos > prev_pos ? pos - prev_pos : prev_pos - pos;
            if (d < L) {
                // verify every overlapping byte against the previous
                // row's shifted view (reads from the OUTPUT arrays, which
                // hold the previous window ending at prev_center + nb)
                int64_t ov = L - d;  // overlap length
                int64_t pbase = prev_center - nb + d;  // output-axis start
                if (memcmp(krow, codes_out + pbase, size_t(ov)) == 0 &&
                    memcmp(mrow, means_out + pbase, size_t(ov) * 2) == 0 &&
                    memcmp(drow, stds_out + pbase, size_t(ov) * 2) == 0 &&
                    memcmp(lrow, lens_out + pbase, size_t(ov) * 2) == 0 &&
                    memcmp(srow, rect_out + pbase * S,
                           size_t(ov) * S * 2) == 0)
                    shift = d;
            }
        }

        if (shift < 0) {                       // fresh segment: all L bases
            memcpy(codes_out + off, krow, size_t(L));
            memcpy(means_out + off, mrow, size_t(L) * 2);
            memcpy(stds_out + off, drow, size_t(L) * 2);
            memcpy(lens_out + off, lrow, size_t(L) * 2);
            memcpy(rect_out + off * S, srow, size_t(L) * S * 2);
            prev_center = off + nb;
            off += L;
        } else if (shift > 0) {                // append the new tail bases
            memcpy(codes_out + off, krow + (L - shift), size_t(shift));
            memcpy(means_out + off, mrow + (L - shift),
                   size_t(shift) * 2);
            memcpy(stds_out + off, drow + (L - shift), size_t(shift) * 2);
            memcpy(lens_out + off, lrow + (L - shift), size_t(shift) * 2);
            memcpy(rect_out + off * S, srow + (L - shift) * S,
                   size_t(shift) * S * 2);
            prev_center += shift;
            off += shift;
        }                                      // shift == 0: duplicate site
        centers_out[r] = int32_t(prev_center);
        prev_pos = pos;
        memcpy(ptok, tok, sizeof(tok));
        memcpy(plen, tlen, sizeof(tlen));
        have_prev = true;
    }
    return off;
}

}  // extern "C"
