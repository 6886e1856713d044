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
//   extraction: dsp_format_feature_cols (feature columns 7-10 as text),
//     dsp_read_norm_stats (MAD normalization + segment stats + float16
//     rect of one read), dsp_build_rect_f16, dsp_format_info_rows,
//     dsp_normalize_mad, dsp_segment_stats_exact, dsp_rect_compat and
//     the CPython-compatible MT19937 sampler (dsp_mt_seed,
//     dsp_mt_sample_sorted).
//   dsp_quantize_i8_f16 / dsp_quantize_i8_f32(in, n, out) -> the dequant
//     scale of a symmetric per-array int8 quantization (the int8 wire);
//     dsp_quantize_i8_f16_portable: the f16 one without AVX-512.
//   dsp_vbz_unpack(in, in_len, count, integer_size, zigzag, out) -> bytes
//     of ``in`` consumed: the Stream VByte layer of a VBZ chunk (HDF5
//     filter 32020) decoded into ``count`` little-endian integers of
//     ``integer_size`` bytes; -1 when the stream is shorter than its
//     control bytes say.
//   HDF5 filters of io/h5filters.py, one stored chunk into ``out``:
//     dsp_lzf_decompress(in, in_len, out, out_cap) -> bytes written (32000);
//     dsp_nbit_decode(in, in_len, parms, nparms, out, out_len) -> 0 (5);
//     dsp_scaleoffset_decode(in, in_len, cd, ncd, out, out_len) -> 0 (6);
//     dsp_szip_decode(in, in_len, options, ppb, bpp, pps, out, out_len)
//       -> 0 (4); each negative for a short or malformed chunk.
//   dsp_lookup3(data, len, initval) -> Jenkins' lookup3 hashlittle, the
//     checksum of HDF5's version 2 structures.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <immintrin.h>
#include <string_view>
#include <unordered_map>
#include <vector>

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

// ---------------------------------------------------------------------
// Extraction (pipeline/extract.py): feature-column text, per-read
// normalization and segment statistics, the float16 signal rect, the
// info columns of the packed wire, and the compat mode's CPython-
// compatible sampler. Copies of the JAX package's library with the
// same arithmetic.
// ---------------------------------------------------------------------

extern "C" {

// means/stds/rect: float64 (UNROUNDED; rounded to 6 decimals half-even here,
// matching np.around + str byte-for-byte for |value| < 9e12 — far beyond
// the MAD-normalized feature domain — including "-0.0" and the
// scientific-notation switch below 1e-4; larger or non-finite values take
// a %g fallback); lens: int32.
// Writes, per site, the text of feature columns 7-10:
//   "MEANS\tSTDS\tLENS\tRECT" (no leading/trailing tab), rect rows joined
// by ';'. out must hold >= n * (3*L + L*S) * 32 bytes (32 bytes/value:
// 21-char fixed-point worst case, 26-byte %g window, separators).
// out_lens[i] receives each site's byte length; returns total bytes.
static char* write_signed6(char* p, double v) {
    double t = v * 1e6;
    // inf/nan/out-of-range would be UB in the int64 cast; such values are
    // outside the feature domain, so fall back to %g (bounded output)
    if (!(t > -9.0e18 && t < 9.0e18)) {
        int n = snprintf(p, 26, "%g", v);
        return p + (n > 0 && n < 26 ? n : 0);
    }
    double f = floor(t);
    double frac = t - f;
    long long r = (long long)f;
    if (frac > 0.5) ++r;
    else if (frac == 0.5 && (r & 1)) ++r;
    bool neg = r < 0 || (r == 0 && std::signbit(v));
    unsigned long long a = neg ? (unsigned long long)(-r) : (unsigned long long)r;
    if (neg) *p++ = '-';
    if (a > 0 && a < 100)      // |x| < 1e-4: Python repr goes scientific
        return write_small_sci(p, a);
    unsigned long long ip = a / 1000000ULL;
    unsigned long long fp = a % 1000000ULL;
    // integer part
    char ibuf[24];
    int ilen = 0;
    if (ip == 0) ibuf[ilen++] = '0';
    while (ip) { ibuf[ilen++] = char('0' + ip % 10); ip /= 10; }
    while (ilen) *p++ = ibuf[--ilen];
    *p++ = '.';
    if (fp == 0) { *p++ = '0'; return p; }
    char digits[6];
    for (int i = 5; i >= 0; --i) { digits[i] = char('0' + fp % 10); fp /= 10; }
    int last = 5;
    while (last > 0 && digits[last] == '0') --last;
    for (int i = 0; i <= last; ++i) *p++ = digits[i];
    return p;
}

int64_t dsp_format_feature_cols(const double* means, const double* stds,
                                const int32_t* lens, const double* rect,
                                int64_t n, int L, int S, char* out,
                                int32_t* out_lens) {
    char* p = out;
    for (int64_t i = 0; i < n; ++i) {
        char* start = p;
        const double* m = means + i * L;
        const double* s = stds + i * L;
        const int32_t* ln = lens + i * L;
        const double* r = rect + i * int64_t(L) * S;
        for (int j = 0; j < L; ++j) {
            if (j) *p++ = ',';
            p = write_signed6(p, m[j]);
        }
        *p++ = '\t';
        for (int j = 0; j < L; ++j) {
            if (j) *p++ = ',';
            p = write_signed6(p, s[j]);
        }
        *p++ = '\t';
        for (int j = 0; j < L; ++j) {
            if (j) *p++ = ',';
            int32_t v = ln[j];
            char ibuf[12];
            int il = 0;
            uint32_t a = v < 0 ? uint32_t(-v) : uint32_t(v);
            if (v < 0) *p++ = '-';
            if (a == 0) ibuf[il++] = '0';
            while (a) { ibuf[il++] = char('0' + a % 10); a /= 10; }
            while (il) *p++ = ibuf[--il];
        }
        *p++ = '\t';
        for (int j = 0; j < L; ++j) {
            if (j) *p++ = ';';
            for (int k = 0; k < S; ++k) {
                if (k) *p++ = ',';
                p = write_signed6(p, r[j * S + k]);
            }
        }
        out_lens[i] = int32_t(p - start);
    }
    return p - out;
}

}  // extern "C"
// ---------------------------------------------------------------------------
// per-site info-row formatting (extraction side)
// ---------------------------------------------------------------------------
//
// Builds the 6-column info prefix "chrom\tpos\tstrand\tpos_in_strand\t
// readname\tread_strand" for every site of one read. Everything but the
// two position columns is constant per read, so the Python genexpr this
// replaces (str() + "\t".join + encode per site) was pure interpreter
// overhead — ~25% of the packed extraction worker's time.

namespace {

inline char* write_i64(char* p, int64_t v) {
    if (v < 0) { *p++ = '-'; v = -v; }
    char tmp[20];
    int k = 0;
    do { tmp[k++] = char('0' + v % 10); v /= 10; } while (v);
    while (k) *p++ = tmp[--k];
    return p;
}

}  // namespace

extern "C" {

// Signal-rect assembly for the packed (f16) wire: per base, either
// evenly-spaced downsampling (length > S) or center-zero-padding
// (length <= S), written directly as IEEE half — fuses the numpy fancy
// gather + astype(float16) pass (python fallback:
// pipeline/extract.py::build_signal_rect, "even" mode only; "compat"
// random sampling stays in Python). norm values are already 6-decimal
// rounded; double->half here uses the same round-to-nearest-even as
// numpy's astype. Indexing is UNCHECKED: the Python wrapper
// (fastparse.build_rect_f16) validates 0 <= start, 0 <= length and
// start+length <= len(norm) and falls back to the clipping numpy path
// for corrupt event tables.
void dsp_build_rect_f16(const double* norm, const int64_t* starts,
                        const int64_t* lengths, int64_t n, int32_t S,
                        _Float16* rect_out) {
    for (int64_t i = 0; i < n; ++i) {
        const int64_t len = lengths[i];
        const int64_t st = starts[i];
        _Float16* row = rect_out + i * S;
        if (len > S) {
            for (int32_t j = 0; j < S; ++j)
                row[j] = _Float16(norm[st + (int64_t(j) * len) / S]);
        } else {
            const int64_t pad = (S - len) / 2;
            for (int64_t j = 0; j < pad; ++j) row[j] = _Float16(0.0f);
            for (int64_t j = 0; j < len; ++j)
                row[pad + j] = _Float16(norm[st + j]);
            for (int64_t j = pad + len; j < S; ++j)
                row[j] = _Float16(0.0f);
        }
    }
}

}  // extern "C"

// Fused per-read extraction kernel (the last Python hot loop of the
// fused fast5->call_mods path: pipeline/extract.py normalize_signals +
// segment_stats + build_signal_rect measured ~66% of the packed
// extraction worker). Replicates the numpy pipeline BIT-EXACTLY:
//   norm  = around((sig - median(sig)) / (median(|sig-median|)/MAD_C), 6)
//   cs    = sequential float64 prefix sums of norm and norm^2
//   mean  = (cs[end]-cs[start]) / max(len,1)
//   std   = sqrt(max(cs2diff/n - mean^2, 0))
//   m16   = half(around(mean, 6)); s16 = half(around(std, 6))
//   rect  = dsp_build_rect_f16 semantics ("even" downsampling)
// numpy facts this relies on: np.median of even-length n is the exact
// mean of the two middle order statistics; np.around(x, 6) is
// rint(x*1e6)/1e6 (round-half-even); np.cumsum is sequential (not
// pairwise) so a running double sum is identical; double->half uses
// round-to-nearest-even. MAD only — np.mean/np.std (zscore mode) use
// pairwise summation, which is NOT replicated here; the Python wrapper
// falls back for zscore. Parity: pipeline/extract.py:40-130 and
// reference extract_features.py:179-190,232-251,364-365.

namespace {

const double MAD_C = 0.6744897501960817;  // Gaussian.ppf(3/4)

// exact np.median: partition, then middle element (odd) or the exact
// mean of the two middle order statistics (even). Mutates buf.
double median_inplace(double* buf, int64_t n) {
    double* mid = buf + n / 2;
    std::nth_element(buf, mid, buf + n);
    const double hi = *mid;
    if (n & 1) return hi;
    const double lo = *std::max_element(buf, mid);
    return (lo + hi) / 2.0;
}

inline double round6d(double v) {
    return std::rint(v * 1e6) / 1e6;
}

}  // namespace

extern "C" {

// signal: rescaled raw signal (float64), ns samples.
// starts/lengths: event table (int64, nb bases); caller validates
//   0 <= start, 0 <= length, start+length <= ns (unchecked here).
// Outputs (caller-allocated): norm_out (ns), means64/stds64 (nb,
// unrounded — segment_stats' values for the TSV/f64 paths),
// means16/stds16/lens16 (nb, the packed wire's rounded f16), rect16
// (nb*S). Returns 0 on success, -1 on alloc failure.
int32_t dsp_read_norm_stats(const double* signal, int64_t ns,
                            const int64_t* starts, const int64_t* lengths,
                            int64_t nb, int32_t S, double* norm_out,
                            double* means64, double* stds64,
                            _Float16* means16, _Float16* stds16,
                            _Float16* lens16, _Float16* rect16) {
    if (ns <= 0 || nb < 0) return -1;
    // reused per thread: a fresh 2.7 MB (three ns-sized arrays at a
    // typical read) of allocation + page faults per call measured as a
    // visible slice of this kernel's 3.6 ms/read; the GIL is held by
    // ctypes around the call but worker PROCESSES each get their own
    // statics anyway
    thread_local std::vector<double> scratch, cs, cs2;
    try {
        scratch.assign(signal, signal + ns);
        cs.resize(size_t(ns) + 1);
        cs2.resize(size_t(ns) + 1);
    } catch (...) {
        return -1;
    }
    const double med = median_inplace(scratch.data(), ns);
    for (int64_t i = 0; i < ns; ++i)
        scratch[size_t(i)] = std::fabs(signal[i] - med);
    const double scale = median_inplace(scratch.data(), ns) / MAD_C;

    // normalize + 6-dp round + sequential prefix sums in one pass
    cs[0] = 0.0;
    cs2[0] = 0.0;
    if (scale == 0.0) {
        for (int64_t i = 0; i < ns; ++i) {
            const double v = round6d(signal[i]);
            norm_out[i] = v;
            cs[size_t(i) + 1] = cs[size_t(i)] + v;
            cs2[size_t(i) + 1] = cs2[size_t(i)] + v * v;
        }
    } else {
        for (int64_t i = 0; i < ns; ++i) {
            const double v = round6d((signal[i] - med) / scale);
            norm_out[i] = v;
            cs[size_t(i) + 1] = cs[size_t(i)] + v;
            cs2[size_t(i) + 1] = cs2[size_t(i)] + v * v;
        }
    }

    for (int64_t i = 0; i < nb; ++i) {
        const int64_t st = starts[i];
        const int64_t len = lengths[i];
        const int64_t en = st + len;
        const double n = double(len > 1 ? len : 1);
        const double mean = (cs[size_t(en)] - cs[size_t(st)]) / n;
        double var = (cs2[size_t(en)] - cs2[size_t(st)]) / n - mean * mean;
        if (var < 0.0) var = 0.0;
        const double sd = std::sqrt(var);
        means64[i] = mean;
        stds64[i] = sd;
        means16[i] = _Float16(round6d(mean));
        stds16[i] = _Float16(round6d(sd));
        lens16[i] = _Float16(double(len));
    }
    // S == 0: caller doesn't want the f16 rect (e.g. the TSV path
    // rebuilds it in float64 for 6-dp text emission) — skip the nb*S
    // gather entirely instead of computing values that get discarded
    if (S > 0)
        dsp_build_rect_f16(norm_out, starts, lengths, nb, S, rect16);
    return 0;
}

}  // extern "C"

extern "C" {

// out must hold n * (chrom_len + strand_len + readname_len +
// read_strand_len + 47) bytes: two int64 columns are <= 21 bytes each
// (20 digits + sign) plus 5 tab separators. Writes each row's byte
// length into row_lens. Returns total bytes written.
int64_t dsp_format_info_rows(const char* chrom, int64_t chrom_len,
                             const char* strand, int64_t strand_len,
                             const char* readname, int64_t readname_len,
                             const char* read_strand,
                             int64_t read_strand_len, const int64_t* pos,
                             const int64_t* pis, int64_t n, char* out,
                             int64_t* row_lens) {
    char* p = out;
    for (int64_t i = 0; i < n; ++i) {
        char* row = p;
        memcpy(p, chrom, size_t(chrom_len));
        p += chrom_len;
        *p++ = '\t';
        p = write_i64(p, pos[i]);
        *p++ = '\t';
        memcpy(p, strand, size_t(strand_len));
        p += strand_len;
        *p++ = '\t';
        p = write_i64(p, pis[i]);
        *p++ = '\t';
        memcpy(p, readname, size_t(readname_len));
        p += readname_len;
        *p++ = '\t';
        memcpy(p, read_strand, size_t(read_strand_len));
        p += read_strand_len;
        row_lens[i] = p - row;
    }
    return p - out;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Compat-mode extraction kernels. The reference's
// numerics — per-event np.mean/np.std (PAIRWISE summation, not the
// cumsum of the fast path) and random.sample sorted signal downsampling
// (reference extract_features.py:248,364-365) — used to run as per-event
// Python in pipeline/extract.py (segment_stats_exact,
// build_signal_rect("compat")), making byte-parity validation on real
// reads an order of magnitude slower than fast mode. These replicate
// both BIT-EXACTLY:
//   - pairwise_sum follows numpy's umath pairwise summation order
//     (8-wide unrolled blocks of <=128, halving recursion rounded to a
//     multiple of 8) — fuzz-verified equal to np.add.reduce on this
//     build for every length 1..3000 (tests/test_native_compat.py);
//   - the MT19937 + sample() pair replicates CPython's random.Random
//     (_randommodule.c init_by_array seeding, getrandbits-based
//     _randbelow rejection, random.py sample()'s pool-swap /
//     rejection-set split at setsize) so a native-sampled run is
//     byte-identical to the pure-Python chain under the same seed.

namespace {

double pairwise_sum(const double* a, int64_t n) {
    if (n < 8) {
        double res = 0.0;
        for (int64_t i = 0; i < n; ++i) res += a[i];
        return res;
    }
    if (n <= 128) {
        double r[8];
        for (int j = 0; j < 8; ++j) r[j] = a[j];
        int64_t i = 8;
        for (; i + 8 <= n; i += 8)
            for (int j = 0; j < 8; ++j) r[j] += a[i + j];
        double res = ((r[0] + r[1]) + (r[2] + r[3])) +
                     ((r[4] + r[5]) + (r[6] + r[7]));
        for (; i < n; ++i) res += a[i];
        return res;
    }
    int64_t n2 = n / 2;
    n2 -= n2 % 8;
    return pairwise_sum(a, n2) + pairwise_sum(a + n2, n - n2);
}

// --- CPython-compatible MT19937 (state: 624 words + index) ---

const int MT_N = 624;

void mt_init_genrand(uint32_t* mt, uint32_t s) {
    mt[0] = s;
    for (int i = 1; i < MT_N; ++i)
        mt[i] = 1812433253u * (mt[i - 1] ^ (mt[i - 1] >> 30)) + uint32_t(i);
}

uint32_t mt_next(uint32_t* mt, uint32_t* idx) {
    const uint32_t UPPER = 0x80000000u, LOWER = 0x7fffffffu;
    if (*idx >= uint32_t(MT_N)) {
        for (int i = 0; i < MT_N; ++i) {
            const uint32_t y = (mt[i] & UPPER) | (mt[(i + 1) % MT_N] & LOWER);
            uint32_t v = mt[(i + 397) % MT_N] ^ (y >> 1);
            if (y & 1u) v ^= 0x9908b0dfu;
            mt[i] = v;
        }
        *idx = 0;
    }
    uint32_t y = mt[(*idx)++];
    y ^= y >> 11;
    y ^= (y << 7) & 0x9d2c5680u;
    y ^= (y << 15) & 0xefc60000u;
    y ^= y >> 18;
    return y;
}

// _randbelow_with_getrandbits: k = n.bit_length() rejection sampling,
// getrandbits(k<=32) = genrand_uint32() >> (32-k). Only valid for
// n < 2^32: CPython's getrandbits(k>32) consumes multiple 32-bit words
// and a (32-k) shift here would be negative (UB). Callers must bound n
// (dsp_mt_sample_sorted returns -1 past the bound so the Python wrapper
// falls back to random.sample); the clamp below is a second line of
// defense, never a correct stream.
int64_t mt_randbelow(uint32_t* mt, uint32_t* idx, int64_t n) {
    int k = 0;
    for (int64_t v = n; v; v >>= 1) ++k;
    if (k > 32) return n - 1;  // unreachable via guarded entry points
    for (;;) {
        const int64_t r = int64_t(mt_next(mt, idx) >> (32 - k));
        if (r < n) return r;
    }
}

}  // namespace

extern "C" {

// Seed the 625-word state (624 MT words + current index) exactly like
// random.Random(int): init_by_array over the little-endian 32-bit words
// of abs(seed) (the Python wrapper splits the int).
void dsp_mt_seed(uint32_t* state, const uint32_t* key, int64_t klen) {
    uint32_t* mt = state;
    mt_init_genrand(mt, 19650218u);
    int64_t i = 1, j = 0;
    int64_t k = MT_N > klen ? MT_N : klen;
    for (; k; --k) {
        mt[i] = (mt[i] ^ ((mt[i - 1] ^ (mt[i - 1] >> 30)) * 1664525u)) +
                key[j] + uint32_t(j);
        ++i; ++j;
        if (i >= MT_N) { mt[0] = mt[MT_N - 1]; i = 1; }
        if (j >= klen) j = 0;
    }
    for (k = MT_N - 1; k; --k) {
        mt[i] = (mt[i] ^ ((mt[i - 1] ^ (mt[i - 1] >> 30)) * 1566083941u)) -
                uint32_t(i);
        ++i;
        if (i >= MT_N) { mt[0] = mt[MT_N - 1]; i = 1; }
    }
    mt[0] = 0x80000000u;
    state[MT_N] = MT_N;   // index: force initial twist, like CPython
}

// random.sample(range(n), k) consuming the stream exactly like
// random.py (pool-swap for n <= setsize, rejection set otherwise),
// then sorted ascending. Returns 0, or -1 on invalid k/n.
int32_t dsp_mt_sample_sorted(uint32_t* state, int64_t n, int64_t k,
                             int64_t* out) {
    if (k < 0 || n < 0 || k > n) return -1;
    // mt_randbelow matches CPython only for n < 2^32 (single getrandbits
    // word); larger event counts must take the Python random.sample path
    if (n > int64_t(0xffffffffll)) return -1;
    uint32_t* mt = state;
    uint32_t* idx = state + MT_N;
    int64_t setsize = 21;
    if (k > 5)
        setsize += int64_t(std::pow(4.0, std::ceil(
            std::log(double(k) * 3.0) / std::log(4.0))));
    if (n <= setsize) {
        thread_local std::vector<int64_t> pool;
        try { pool.resize(size_t(n)); } catch (...) { return -1; }
        for (int64_t t = 0; t < n; ++t) pool[size_t(t)] = t;
        for (int64_t t = 0; t < k; ++t) {
            const int64_t j = mt_randbelow(mt, idx, n - t);
            out[t] = pool[size_t(j)];
            pool[size_t(j)] = pool[size_t(n - t - 1)];
        }
    } else {
        thread_local std::vector<int64_t> sel;
        sel.clear();
        for (int64_t t = 0; t < k; ++t) {
            int64_t j = mt_randbelow(mt, idx, n);
            while (std::find(sel.begin(), sel.end(), j) != sel.end())
                j = mt_randbelow(mt, idx, n);
            sel.push_back(j);
            out[t] = j;
        }
    }
    std::sort(out, out + k);
    return 0;
}

// MAD normalization + 6-dp rounding only (compat mode pairs it with the
// exact pairwise stats below instead of the fast path's cumsum stats).
int32_t dsp_normalize_mad(const double* signal, int64_t ns,
                          double* norm_out) {
    if (ns <= 0) return -1;
    thread_local std::vector<double> scratch;
    try { scratch.assign(signal, signal + ns); } catch (...) { return -1; }
    const double med = median_inplace(scratch.data(), ns);
    for (int64_t i = 0; i < ns; ++i)
        scratch[size_t(i)] = std::fabs(signal[i] - med);
    const double scale = median_inplace(scratch.data(), ns) / MAD_C;
    if (scale == 0.0) {
        for (int64_t i = 0; i < ns; ++i) norm_out[i] = round6d(signal[i]);
    } else {
        for (int64_t i = 0; i < ns; ++i)
            norm_out[i] = round6d((signal[i] - med) / scale);
    }
    return 0;
}

// Bit-exact np.mean / np.std per event segment (pairwise summation; the
// mean-subtracted squares are materialized then pairwise-summed, the
// exact op sequence of numpy's _var). n == 0 segments yield nan like
// np.mean(empty) (0.0/0.0).
int32_t dsp_segment_stats_exact(const double* norm, const int64_t* starts,
                                const int64_t* lengths, int64_t nb,
                                double* means, double* stds) {
    thread_local std::vector<double> sq;
    for (int64_t i = 0; i < nb; ++i) {
        const int64_t len = lengths[i];
        const double* seg = norm + starts[i];
        const double n = double(len);
        const double mean = pairwise_sum(seg, len) / n;
        try { sq.resize(size_t(len > 0 ? len : 0)); } catch (...) {
            return -1;
        }
        for (int64_t j = 0; j < len; ++j) {
            const double d = seg[j] - mean;
            sq[size_t(j)] = d * d;
        }
        means[i] = mean;
        stds[i] = std::sqrt(pairwise_sum(sq.data(), len) / n);
    }
    return 0;
}

// build_signal_rect("compat") in one pass: short events center-
// zero-padded (identical to the "even" path's short branch), long
// events downsampled by a sorted random.sample drawn from ``state`` in
// ascending row order — the exact stream order of the Python loop over
// long_rows (pipeline/extract.py build_signal_rect).
int32_t dsp_rect_compat(const double* norm, const int64_t* starts,
                        const int64_t* lengths, int64_t nb, int32_t S,
                        uint32_t* state, double* rect) {
    thread_local std::vector<int64_t> picks;
    try { picks.resize(size_t(S)); } catch (...) { return -1; }
    for (int64_t i = 0; i < nb; ++i) {
        const int64_t len = lengths[i];
        const int64_t st = starts[i];
        double* row = rect + i * S;
        if (len > S) {
            if (dsp_mt_sample_sorted(state, len, S, picks.data()) != 0)
                return -1;
            for (int32_t r = 0; r < S; ++r)
                row[r] = norm[st + picks[size_t(r)]];
        } else {
            const int64_t pad_left = (int64_t(S) - len) / 2;
            for (int32_t r = 0; r < S; ++r) {
                const int64_t k = int64_t(r) - pad_left;
                row[r] = (k >= 0 && k < len) ? norm[st + k] : 0.0;
            }
        }
    }
    return 0;
}

}  // extern "C"


// ---------------------------------------------------------------------------
// int8 wire quantizers (JAX featparse.cpp:580-695)
// ---------------------------------------------------------------------------

namespace {

// Round-half-even without touching the FP environment: adding and
// subtracting 1.5*2^23 forces the mantissa to integer granularity for
// |x| <= 2^22 (quantized values are bounded by 127, far inside). Bit-exact
// with np.rint on the same f32 operand.
inline float round_even_f32(float x) {
    const float magic = 12582912.0f;  // 1.5 * 2^23
    float r = x + magic;
    return r - magic;
}

// Symmetric per-array int8 quantization, bit-exact with numpy: amax
// reduced in f32 (NaN propagating, as np.max), scale computed in f64 then
// applied as f32, f32 division, round-half-even, clip to [-127, 127], NaN
// to 0 (numpy's f32->int8 astype). Returns the dequant scale (amax/127,
// or 1.0 for all-zero or empty input).
template <typename T>
float quantize_impl(const T* in, int64_t n, int8_t* out) {
    float amax = 0.0f;
    for (int64_t i = 0; i < n; ++i) {
        float v = fabsf(float(in[i]));
        if (v > amax || v != v) amax = v;
    }
    double sd = double(amax) / 127.0;
    float s = (sd == 0.0) ? 1.0f : float(sd);
    // division, not inverse-multiply: bit parity with numpy's a32/scale
    for (int64_t i = 0; i < n; ++i) {
        float r = round_even_f32(float(in[i]) / s);
        if (r > 127.0f) r = 127.0f;
        else if (r < -127.0f) r = -127.0f;
        out[i] = (r != r) ? int8_t(0) : int8_t(r);
    }
    return s;
}

// The float16 hot path, hand-vectorized for AVX-512 and chosen at run
// time (the library is built without -march=native, so one build serves
// every x86-64 host): vcvtph2ps converts 16 halves an iteration, vdivps
// keeps IEEE division, vroundscaleps rounds half-even, vpmovdb packs to
// int8. The same bits as quantize_impl.
__attribute__((target("avx512f,avx512bw")))
float quantize_f16_avx512(const _Float16* in, int64_t n, int8_t* out) {
    const __m512i abs_mask = _mm512_set1_epi32(0x7fffffff);
    __m512 vmax = _mm512_setzero_ps();
    __mmask16 any_nan = 0;   // vmaxps drops NaN lanes; track separately
    int64_t i = 0;
    for (; i + 16 <= n; i += 16) {
        __m512 v = _mm512_cvtph_ps(
            _mm256_loadu_si256((const __m256i*)(in + i)));
        any_nan |= _mm512_cmp_ps_mask(v, v, _CMP_UNORD_Q);
        // |v| by an integer AND (AVX-512F; _mm512_and_ps needs DQ)
        vmax = _mm512_max_ps(vmax, _mm512_castsi512_ps(_mm512_and_si512(
            _mm512_castps_si512(v), abs_mask)));
    }
    float amax = any_nan ? nanf("") : _mm512_reduce_max_ps(vmax);
    for (; i < n; ++i) {
        float v = fabsf(float(in[i]));
        if (v > amax || v != v) amax = v;
    }
    double sd = double(amax) / 127.0;
    float s = (sd == 0.0) ? 1.0f : float(sd);
    const __m512 vs = _mm512_set1_ps(s);
    const __m512 lo = _mm512_set1_ps(-127.0f);
    const __m512 hi = _mm512_set1_ps(127.0f);
    i = 0;
    for (; i + 16 <= n; i += 16) {
        __m512 v = _mm512_cvtph_ps(
            _mm256_loadu_si256((const __m256i*)(in + i)));
        __m512 r = _mm512_roundscale_ps(
            _mm512_div_ps(v, vs),
            _MM_FROUND_TO_NEAREST_INT | _MM_FROUND_NO_EXC);
        // the bound as FIRST operand: vmaxps/vminps return the second
        // source when either is NaN, so NaN survives the clamp and packs
        // to 0 (0x80000000 truncated), as numpy's astype gives
        r = _mm512_min_ps(hi, _mm512_max_ps(lo, r));
        _mm_storeu_si128(
            (__m128i*)(out + i),
            _mm512_cvtepi32_epi8(_mm512_cvtps_epi32(r)));
    }
    for (; i < n; ++i) {
        float r = round_even_f32(float(in[i]) / s);
        if (r > 127.0f) r = 127.0f;
        else if (r < -127.0f) r = -127.0f;
        out[i] = (r != r) ? int8_t(0) : int8_t(r);
    }
    return s;
}

bool has_avx512bw() {
    static const bool ok = __builtin_cpu_supports("avx512f") &&
                           __builtin_cpu_supports("avx512bw");
    return ok;
}

}  // namespace

extern "C" {

float dsp_quantize_i8_f16(const _Float16* in, int64_t n, int8_t* out) {
    if (has_avx512bw()) return quantize_f16_avx512(in, n, out);
    return quantize_impl(in, n, out);
}

float dsp_quantize_i8_f32(const float* in, int64_t n, int8_t* out) {
    return quantize_impl(in, n, out);
}

// the portable loop of dsp_quantize_i8_f16, whatever the host has (the
// tests hold both against the JAX library)
float dsp_quantize_i8_f16_portable(const _Float16* in, int64_t n,
                                   int8_t* out) {
    return quantize_impl(in, n, out);
}

}  // extern "C"


// ---------------------------------------------------------------------------
// VBZ (HDF5 filter 32020, nanoporetech/vbz_compression): the Stream VByte
// layer, read after io/vbz.py has undone the zstd layer
// ---------------------------------------------------------------------------

namespace {

const uint32_t kVbzMask[4] = {0xFFu, 0xFFFFu, 0xFFFFFFu, 0xFFFFFFFFu};

// One value type and delta mode: while 4 bytes remain, a value is one
// unaligned little-endian 4-byte load masked to its length (x86-64 is
// little-endian); the stream's last values take the bytewise path.
template <typename T, bool ZigZag>
int64_t vbz_unpack(const uint8_t* in, int64_t in_len, int64_t count,
                   uint8_t* out) {
    const int64_t nctrl = (count + 3) / 4;
    if (count < 0 || nctrl > in_len) return -1;
    const uint8_t* ctrl = in;
    const uint8_t* p = in + nctrl;
    const uint8_t* end = in + in_len;
    uint32_t prev = 0;
    for (int64_t i = 0; i < count; ++i) {
        const int key = (ctrl[i >> 2] >> (2 * (i & 3))) & 3;
        uint32_t v;
        if (end - p >= 4) {
            std::memcpy(&v, p, 4);
            v &= kVbzMask[key];
        } else {
            if (end - p < key + 1) return -1;
            v = 0;
            for (int b = 0; b <= key; ++b) v |= uint32_t(p[b]) << (8 * b);
        }
        p += key + 1;
        if (ZigZag) {
            prev += (v >> 1) ^ (0u - (v & 1u));
            v = prev;
        }
        const T t = T(v);
        std::memcpy(out + i * sizeof(T), &t, sizeof(T));
    }
    return p - in;
}

template <typename T>
int64_t vbz_unpack_delta(const uint8_t* in, int64_t in_len, int64_t count,
                         int32_t zigzag, uint8_t* out) {
    return zigzag ? vbz_unpack<T, true>(in, in_len, count, out)
                  : vbz_unpack<T, false>(in, in_len, count, out);
}

}  // namespace

extern "C" {

// Classic Stream VByte (Lemire et al., "Stream VByte: Faster
// Byte-Oriented Integer Compression", 2018; the layout of the
// streamvbyte library's streamvbyte_encode that vbz calls): ceil(count/4)
// control bytes, two bits per value, the first value of each group of
// four in the low bits, key k meaning k+1 data bytes; then the data
// bytes, each value little-endian. With ``zigzag`` each decoded word is
// the zig-zag code of the delta from the previous value, the values
// widened to 32 bits and the first delta taken from 0 (vbz's
// zigzag_delta_encode); sums wrap at 32 bits. Each value is narrowed to
// ``integer_size`` bytes (1, 2 or 4) as vbz narrows its uint32 buffer;
// any other size returns -1.
int64_t dsp_vbz_unpack(const uint8_t* in, int64_t in_len, int64_t count,
                       int32_t integer_size, int32_t zigzag, uint8_t* out) {
    switch (integer_size) {
        case 1: return vbz_unpack_delta<uint8_t>(in, in_len, count, zigzag,
                                                 out);
        case 2: return vbz_unpack_delta<uint16_t>(in, in_len, count, zigzag,
                                                  out);
        case 4: return vbz_unpack_delta<uint32_t>(in, in_len, count, zigzag,
                                                  out);
        default: return -1;
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// HDF5 filters of io/h5filters.py: LZF (32000, the filter h5py ships),
// N-bit (5), scale-offset (6) and szip (4, CCSDS 121.0 Rice coding as
// libaec decodes it). Each decodes one stored chunk into a buffer of the
// chunk's size; each returns a negative code instead of reading or
// writing out of bounds.
// ---------------------------------------------------------------------------

namespace {

// ``nbits`` (at most 64) bits at bit ``pos`` of ``p``, the most
// significant bit of each byte first; false past ``nbytes``.
inline bool read_bits(const uint8_t* p, int64_t nbytes, int64_t& pos,
                      int nbits, uint64_t& v) {
    if (pos + nbits > nbytes * 8) return false;
    uint64_t r = 0;
    int left = nbits;
    while (left > 0) {
        const int off = int(pos & 7);
        const int avail = 8 - off;
        const int take = avail < left ? avail : left;
        const uint32_t bits =
            (uint32_t(p[pos >> 3]) >> (avail - take)) & ((1u << take) - 1);
        r = (r << take) | bits;
        left -= take;
        pos += take;
    }
    v = r;
    return true;
}

// the count of 0 bits before the next 1 bit (a fundamental sequence
// code), the 1 consumed; -1 past the end
inline int64_t read_fs(const uint8_t* p, int64_t nbytes, int64_t& pos) {
    int64_t n = 0;
    const int64_t end = nbytes * 8;
    while (pos < end) {
        if (!(pos & 7) && p[pos >> 3] == 0 && pos + 8 <= end) {
            n += 8;
            pos += 8;
            continue;
        }
        const bool bit = (p[pos >> 3] >> (7 - (pos & 7))) & 1;
        ++pos;
        if (bit) return n;
        ++n;
    }
    return -1;
}

inline void put_uint(uint8_t* out, uint64_t v, int size, bool big) {
    for (int b = 0; b < size; ++b) {
        const uint8_t byte = uint8_t(v >> (8 * b));
        out[big ? size - 1 - b : b] = byte;
    }
}

inline uint64_t get_uint(const uint8_t* in, int size, bool big) {
    uint64_t v = 0;
    for (int b = 0; b < size; ++b)
        v |= uint64_t(in[big ? size - 1 - b : b]) << (8 * b);
    return v;
}

// N-bit: one element of the type whose parameters start at parms[i]
// (its class code already read), its bits read from the stream.
int64_t nbit_one(const uint8_t* in, int64_t in_len, int64_t& pos,
                 const uint32_t* parms, int64_t nparms, int64_t& i,
                 int cls, uint8_t* out, int64_t out_len, int depth);

int64_t nbit_atomic(const uint8_t* in, int64_t in_len, int64_t& pos,
                    const uint32_t* parms, int64_t nparms, int64_t& i,
                    uint8_t* out, int64_t out_len) {
    if (i + 4 > nparms) return -2;
    const uint32_t size = parms[i], order = parms[i + 1];
    const uint32_t prec = parms[i + 2], off = parms[i + 3];
    i += 4;
    if (size == 0 || size > 8 || prec == 0 || prec + off > 8 * size ||
        order > 1 || int64_t(size) > out_len)
        return -2;
    uint64_t v;
    if (!read_bits(in, in_len, pos, int(prec), v)) return -1;
    put_uint(out, v << off, int(size), order == 1);
    return 0;
}

int64_t nbit_one(const uint8_t* in, int64_t in_len, int64_t& pos,
                 const uint32_t* parms, int64_t nparms, int64_t& i,
                 int cls, uint8_t* out, int64_t out_len, int depth) {
    if (depth > 16) return -2;
    if (cls == 1)
        return nbit_atomic(in, in_len, pos, parms, nparms, i, out, out_len);
    if (cls == 4) {                // no-op type: its bytes as they are
        if (i >= nparms) return -2;
        const uint32_t size = parms[i++];
        if (int64_t(size) > out_len) return -2;
        for (uint32_t b = 0; b < size; ++b) {
            uint64_t v;
            if (!read_bits(in, in_len, pos, 8, v)) return -1;
            out[b] = uint8_t(v);
        }
        return 0;
    }
    if (cls == 2) {                          // array: total size, base type
        if (i + 3 > nparms) return -2;
        const uint32_t total = parms[i++];
        const int base = int(parms[i++]);
        const uint32_t bsize = parms[i];     // every base type starts so
        if (bsize == 0 || total % bsize || int64_t(total) > out_len)
            return -2;
        const int64_t start = i;
        for (uint32_t e = 0; e < total / bsize; ++e) {
            i = start;
            const int64_t rc = nbit_one(in, in_len, pos, parms, nparms, i,
                                        base, out + int64_t(e) * bsize,
                                        bsize, depth + 1);
            if (rc) return rc;
        }
        return 0;
    }
    if (cls == 3) {                          // compound: size, members
        if (i + 2 > nparms) return -2;
        const uint32_t size = parms[i++];
        const uint32_t nmembers = parms[i++];
        if (int64_t(size) > out_len) return -2;
        for (uint32_t m = 0; m < nmembers; ++m) {
            if (i + 2 > nparms) return -2;
            const uint32_t moff = parms[i++];
            const int mcls = int(parms[i++]);
            if (moff >= size) return -2;
            const int64_t rc = nbit_one(in, in_len, pos, parms, nparms, i,
                                        mcls, out + moff, size - moff,
                                        depth + 1);
            if (rc) return rc;
        }
        return 0;
    }
    return -2;
}

}  // namespace

extern "C" {

// LZF (liblzf's lzf_decompress): a control byte below 32 starts a run of
// ctrl+1 literal bytes; else a back reference of (ctrl >> 5) + 2 bytes
// (7: plus the next byte) at distance ((ctrl & 31) << 8) + next byte + 1.
// Returns the bytes written; -1 for data that is no LZF stream, -2 when
// ``out_cap`` is too small (liblzf's E2BIG).
int64_t dsp_lzf_decompress(const uint8_t* in, int64_t in_len, uint8_t* out,
                           int64_t out_cap) {
    const uint8_t* ip = in;
    const uint8_t* const in_end = in + in_len;
    int64_t op = 0;
    while (ip < in_end) {
        uint32_t ctrl = *ip++;
        if (ctrl < 32) {
            ++ctrl;
            if (op + ctrl > out_cap) return -2;
            if (ip + ctrl > in_end) return -1;
            std::memcpy(out + op, ip, ctrl);
            op += ctrl;
            ip += ctrl;
        } else {
            uint32_t len = ctrl >> 5;
            int64_t ref = op - int64_t((ctrl & 0x1f) << 8) - 1;
            if (ip >= in_end) return -1;
            if (len == 7) {
                len += *ip++;
                if (ip >= in_end) return -1;
            }
            ref -= *ip++;
            len += 2;
            if (op + len > out_cap) return -2;
            if (ref < 0) return -1;
            for (uint32_t k = 0; k < len; ++k) out[op + k] = out[ref + k];
            op += len;
        }
    }
    return op;
}

// N-bit (HDF5's H5Z__filter_nbit, decompression): ``parms`` the
// filter's client data values (total count, need-not-compress flag,
// elements, then the type's parameters: atomic 1 size order precision
// offset, array 2 size base, compound 3 size members (offset type)...,
// no-op 4 size). Each element's significant bits were packed most
// significant first; they return to their offset, the other bits 0.
// Returns 0; -1 for a stream shorter than its elements, -2 for bad
// parameters or an output of another size.
int64_t dsp_nbit_decode(const uint8_t* in, int64_t in_len,
                        const uint32_t* parms, int64_t nparms, uint8_t* out,
                        int64_t out_len) {
    if (nparms < 5) return -2;
    const int64_t nelmts = parms[2];
    const int cls = int(parms[3]);
    const int64_t size = parms[4];
    if (size == 0 || nelmts * size != out_len) return -2;
    std::memset(out, 0, size_t(out_len));
    int64_t pos = 0;
    for (int64_t e = 0; e < nelmts; ++e) {
        int64_t i = 4;
        int64_t rc;
        if (cls == 1) {
            rc = nbit_atomic(in, in_len, pos, parms, nparms, i, out + e * size,
                             size);
        } else {
            rc = nbit_one(in, in_len, pos, parms, nparms, i, cls,
                          out + e * size, size, 0);
        }
        if (rc) return rc;
    }
    return 0;
}

// scale-offset (HDF5's H5Z__filter_scaleoffset, decompression): ``cd``
// the filter's client data values (scale type, scale factor, elements,
// class 0 integer / 1 float, size, sign, byte order, fill value
// defined, the fill value's bytes from cd[8] on). The chunk is a 21-byte
// header (minbits, a little-endian uint32; the minimum's byte count and
// bytes) and each element's ``minbits`` low bits, most significant
// first. minbits equal to the type's bits: the elements as stored;
// minbits 0: every element the minimum. Integers: the minimum added, the
// all-ones value the fill value where one is defined; floats (D-scale):
// the integer over 10^D plus the minimum. Returns 0, -1 for a short
// chunk, -2 for bad parameters (E-scale, which HDF5 does not write).
int64_t dsp_scaleoffset_decode(const uint8_t* in, int64_t in_len,
                               const uint32_t* cd, int64_t ncd, uint8_t* out,
                               int64_t out_len) {
    if (ncd < 8) return -2;
    const uint32_t scale_type = cd[0];
    const int32_t dscale = int32_t(cd[1]);
    const int64_t nelmts = cd[2];
    const uint32_t cls = cd[3], size = cd[4], order = cd[6];
    const bool fill = cd[7] == 1;
    if (!(size == 1 || size == 2 || size == 4 || size == 8) || cls > 1 ||
        order > 1 || nelmts * size != out_len ||
        (cls == 1 && (scale_type != 0 || size < 4)))
        return -2;
    if (in_len < 21) return -1;
    const uint32_t minbits = uint32_t(get_uint(in, 4, false));
    const int mvsize = in[4] < 8 ? in[4] : 8;
    const uint64_t minval = get_uint(in + 5, mvsize, false);
    const bool big = order == 1;
    const uint8_t* data = in + 21;
    const int64_t data_len = in_len - 21;
    if (minbits > 8 * size) return -2;
    if (minbits == 8 * size) {
        if (data_len < out_len) return -1;
        for (int64_t e = 0; e < nelmts; ++e)
            put_uint(out + e * size,
                     get_uint(data + e * size, int(size), false), int(size),
                     big);
        return 0;
    }
    uint64_t filval = 0;
    if (fill) {
        if (ncd < 8 + (int64_t(size) + 3) / 4) return -2;
        for (uint32_t b = 0; b < size; ++b)
            filval |= uint64_t((cd[8 + b / 4] >> (8 * (b % 4))) & 0xff)
                      << (8 * b);
    }
    const uint64_t all_ones = minbits ? (uint64_t(1) << minbits) - 1 : 0;
    const uint64_t type_mask =
        size == 8 ? ~uint64_t(0) : (uint64_t(1) << (8 * size)) - 1;
    int64_t pos = 0;
    for (int64_t e = 0; e < nelmts; ++e) {
        uint64_t v = 0;
        if (minbits && !read_bits(data, data_len, pos, int(minbits), v))
            return -1;
        uint64_t w;
        if (cls == 0) {
            w = (fill && v == all_ones) ? filval : (v + minval) & type_mask;
        } else if (size == 4) {
            float mn, fv, r;
            const uint32_t mb = uint32_t(minval), fb = uint32_t(filval);
            std::memcpy(&mn, &mb, 4);
            std::memcpy(&fv, &fb, 4);
            const int32_t iv = int32_t(uint32_t(v));
            if (fill && iv == int32_t(uint32_t(all_ones))) {
                r = fv;
            } else {
                const float p = powf(10.0f, float(dscale));
                r = float(iv) / p + mn;
            }
            uint32_t rb;
            std::memcpy(&rb, &r, 4);
            w = rb;
        } else {
            double mn, fv, r;
            std::memcpy(&mn, &minval, 8);
            std::memcpy(&fv, &filval, 8);
            const int64_t iv = int64_t(v);
            if (fill && iv == int64_t(all_ones)) {
                r = fv;
            } else {
                const double p = pow(10.0, double(dscale));
                r = double(iv) / p + mn;
            }
            std::memcpy(&w, &r, 8);
        }
        put_uint(out + e * size, w, int(size), big);
    }
    return 0;
}

// szip (HDF5's H5Z__filter_szip through libaec's SZ_BufftoBuffDecompress):
// CCSDS 121.0-B Rice coding. ``options`` HDF5's szip option mask (32:
// nearest-neighbour preprocessing, 16: samples most significant byte
// first), ``ppb`` samples a block, ``bpp`` bits a sample (32 and 64 are
// coded as bytes, interleaved by byte plane), ``pps`` samples a scanline
// (a reference sample interval of ceil(pps / ppb) blocks; a scanline
// that is no whole number of blocks was padded). Each block: an ID
// (3, 4 or 5 bits), then a low-entropy block (zero-block run or second
// extension), an uncompressed block, or a split-sample block; with
// preprocessing each interval starts with an n-bit reference sample and
// the rest are mapped prediction residuals. Writes ``out_len`` bytes;
// returns 0, -1 for a stream shorter than that, -2 for bad parameters,
// -3 for a malformed stream.
int64_t dsp_szip_decode(const uint8_t* in, int64_t in_len, int32_t options,
                        int32_t ppb, int32_t bpp, int32_t pps, uint8_t* out,
                        int64_t out_len) {
    if (ppb < 1 || ppb > 4096 || pps < 1 || bpp < 1 || bpp > 64 ||
        (bpp > 32 && bpp != 64))
        return -2;
    const bool pp = options & 32, msb = options & 16;
    const bool interleave = bpp == 32 || bpp == 64;
    const int n = interleave ? 8 : bpp;
    const int psize = n > 16 ? 4 : n > 8 ? 2 : 1;
    if (out_len % psize) return -2;
    const int64_t J = ppb;
    const int64_t rsi = (pps + J - 1) / J;
    const bool pad = pps % J != 0;
    const int64_t samples = out_len / psize;
    const int64_t lines = (samples + pps - 1) / pps;
    const int64_t target = pad ? rsi * J * lines : samples;
    const int id_len = n > 16 ? 5 : n > 8 ? 4 : 3;
    const uint64_t id_max = (uint64_t(1) << id_len) - 1;
    const uint64_t xmax = n == 64 ? ~uint64_t(0) : (uint64_t(1) << n) - 1;
    std::vector<uint8_t> bytes;                  // interleaved byte planes
    if (interleave) bytes.resize(size_t(samples));
    std::vector<uint64_t> buf;
    buf.reserve(size_t(rsi * J));
    int64_t pos = 0, done = 0;
    auto emit = [&](int64_t p, uint64_t v) {
        int64_t k = p;
        if (pad) {
            const int64_t line = p / (rsi * J), col = p % (rsi * J);
            if (col >= pps) return;
            k = line * pps + col;
        }
        if (k >= samples) return;
        if (interleave) bytes[size_t(k)] = uint8_t(v);
        else put_uint(out + k * psize, v, psize, msb);
    };
    while (done < target) {
        buf.clear();
        for (int64_t b = 0; b < rsi && done + int64_t(buf.size()) < target;
             ++b) {
            const bool ref = pp && b == 0;
            uint64_t id, v;
            if (!read_bits(in, in_len, pos, id_len, id)) return -1;
            if (id == 0) {                       // low entropy
                uint64_t se;
                if (!read_bits(in, in_len, pos, 1, se)) return -1;
                if (ref) {
                    if (!read_bits(in, in_len, pos, n, v)) return -1;
                    buf.push_back(v);
                }
                if (se) {                        // second extension
                    int64_t i = ref;
                    while (i < J) {
                        const int64_t m = read_fs(in, in_len, pos);
                        if (m < 0) return -1;
                        if (m > 90) return -3;
                        int64_t s = 0;
                        while ((s + 1) * (s + 2) / 2 <= m) ++s;
                        const int64_t d1 = m - s * (s + 1) / 2;
                        if ((i & 1) == 0) {
                            buf.push_back(uint64_t(s - d1));
                            ++i;
                        }
                        buf.push_back(uint64_t(d1));
                        ++i;
                    }
                } else {                         // a run of zero blocks
                    const int64_t fs = read_fs(in, in_len, pos);
                    if (fs < 0) return -1;
                    int64_t zb = fs + 1;
                    if (zb == 5) {               // to the end of the segment
                        const int64_t used = int64_t(buf.size()) / J;
                        zb = std::min(rsi - used, 64 - used % 64);
                    } else if (zb > 5) {
                        --zb;
                    }
                    if (b + zb > rsi) return -3;
                    buf.insert(buf.end(), size_t(zb * J - ref), 0);
                    b += zb - 1;
                }
            } else if (id == id_max) {           // uncompressed
                for (int64_t i = 0; i < J; ++i) {
                    if (!read_bits(in, in_len, pos, n, v)) return -1;
                    buf.push_back(v);
                }
            } else {                             // split samples, k LSBs
                const int k = int(id) - 1;
                if (ref) {
                    if (!read_bits(in, in_len, pos, n, v)) return -1;
                    buf.push_back(v);
                }
                const size_t first = buf.size();
                for (int64_t i = ref; i < J; ++i) {
                    const int64_t m = read_fs(in, in_len, pos);
                    if (m < 0) return -1;
                    if (k + (64 - __builtin_clzll(uint64_t(m) | 1)) > 64)
                        return -3;
                    buf.push_back(uint64_t(m) << k);
                }
                if (k)
                    for (size_t i = first; i < buf.size(); ++i) {
                        if (!read_bits(in, in_len, pos, k, v)) return -1;
                        buf[i] += v;
                    }
            }
        }
        // undo the preprocessing: the reference as it is, then each
        // mapped residual around the sample before it
        uint64_t last = 0;
        for (size_t i = 0; i < buf.size(); ++i) {
            uint64_t x = buf[i];
            if (pp) {
                if (i == 0) {
                    last = x;
                } else {
                    const uint64_t d = x;
                    const uint64_t half = (d >> 1) + (d & 1);
                    const uint64_t theta = std::min(last, xmax - last);
                    if (half <= theta) {
                        last = (d & 1) ? last - half : last + half;
                    } else if (last <= xmax - last) {
                        last = d;
                    } else {
                        last = xmax - d;
                    }
                    x = last;
                }
            }
            if (x > xmax) return -3;
            emit(done + int64_t(i), x);
        }
        done += int64_t(buf.size());
    }
    if (interleave) {
        const int w = bpp / 8;
        const int64_t words = samples / w;
        for (int64_t i = 0; i < words; ++i)
            for (int j = 0; j < w; ++j)
                out[i * w + j] = bytes[size_t(j * words + i)];
    }
    return 0;
}

}  // extern "C"

extern "C" {

// Bob Jenkins' lookup3 hashlittle, the checksum of HDF5's version 2
// structures (H5_checksum_lookup3), over ``length`` bytes read in any
// alignment.
uint32_t dsp_lookup3(const uint8_t* k, int64_t length, uint32_t initval) {
    auto rot = [](uint32_t x, int r) { return (x << r) | (x >> (32 - r)); };
    auto word = [](const uint8_t* p) {
        return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
               uint32_t(p[3]) << 24;
    };
    uint32_t a, b, c;
    a = b = c = 0xdeadbeefu + uint32_t(length) + initval;
    while (length > 12) {
        a += word(k);
        b += word(k + 4);
        c += word(k + 8);
        a -= c; a ^= rot(c, 4);  c += b;
        b -= a; b ^= rot(a, 6);  a += c;
        c -= b; c ^= rot(b, 8);  b += a;
        a -= c; a ^= rot(c, 16); c += b;
        b -= a; b ^= rot(a, 19); a += c;
        c -= b; c ^= rot(b, 4);  b += a;
        length -= 12;
        k += 12;
    }
    if (length == 0) return c;
    uint8_t tail[12] = {0};
    std::memcpy(tail, k, size_t(length));
    a += word(tail);
    b += word(tail + 4);
    c += word(tail + 8);
    c ^= b; c -= rot(b, 14);
    a ^= c; a -= rot(c, 11);
    b ^= a; b -= rot(a, 25);
    c ^= b; c -= rot(b, 16);
    a ^= c; a -= rot(c, 4);
    b ^= a; b -= rot(a, 14);
    c ^= b; c -= rot(b, 24);
    return c;
}

}  // extern "C"
