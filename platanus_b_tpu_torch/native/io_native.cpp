// Native FASTA/FASTQ decoder: bytes -> 2-bit base codes (0..3, 4 = N).
//
// TPU-native equivalent of the reference's C++ read loaders
// (seqlib.cpp:365-741 ReadFasta*MT and common.h:256 Char2Bin): the hot
// host-side path that feeds the device. Parses an in-memory file image and
// emits one concatenated code array plus per-record offsets, ready to be
// packed into padded device batches without further Python-level work.
//
// Exposed via a C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>

namespace {

// Char2Bin table (common.h:256): ACGT/acgt -> 0..3, everything else -> 4
struct Char2Bin {
    uint8_t t[256];
    Char2Bin() {
        memset(t, 4, sizeof(t));
        t['A'] = t['a'] = 0;
        t['C'] = t['c'] = 1;
        t['G'] = t['g'] = 2;
        t['T'] = t['t'] = 3;
    }
};
const Char2Bin C2B;

}  // namespace

extern "C" {

// Parse FASTA. buf/n: file image. out_codes: capacity >= n bytes.
// out_starts: capacity >= max_records + 1 entries.
// Returns the number of records (out_starts[count] = total code length),
// or -1 if max_records would be exceeded.
long decode_fasta(const char* buf, long n, uint8_t* out_codes,
                  int64_t* out_starts, long max_records) {
    long count = 0;
    int64_t pos = 0;
    long i = 0;
    while (i < n) {
        // skip to header
        while (i < n && buf[i] != '>') ++i;
        if (i >= n) break;
        while (i < n && buf[i] != '\n') ++i;  // skip header line
        ++i;
        if (count >= max_records) return -1;
        out_starts[count] = pos;
        while (i < n && buf[i] != '>') {
            const char c = buf[i];
            if (c != '\n' && c != '\r') out_codes[pos++] = C2B.t[(uint8_t)c];
            ++i;
        }
        ++count;
    }
    out_starts[count] = pos;
    return count;
}

// Parse FASTQ (4-line records; multi-line sequences not supported, as in
// practice for FASTQ).
long decode_fastq(const char* buf, long n, uint8_t* out_codes,
                  int64_t* out_starts, long max_records) {
    long count = 0;
    int64_t pos = 0;
    long i = 0;
    while (i < n) {
        while (i < n && (buf[i] == '\n' || buf[i] == '\r')) ++i;
        if (i >= n) break;
        if (buf[i] != '@') return -2;
        while (i < n && buf[i] != '\n') ++i;  // header
        ++i;
        if (count >= max_records) return -1;
        out_starts[count] = pos;
        while (i < n && buf[i] != '\n' && buf[i] != '\r')
            out_codes[pos++] = C2B.t[(uint8_t)buf[i++]];
        while (i < n && buf[i] != '\n') ++i;
        ++i;
        // '+' line
        while (i < n && buf[i] != '\n') ++i;
        ++i;
        // quality line (same length as seq; just skip to newline)
        while (i < n && buf[i] != '\n') ++i;
        ++i;
        ++count;
    }
    out_starts[count] = pos;
    return count;
}

// Reverse-complement a code array in place (4s preserved).
void revcomp_codes(uint8_t* codes, long n) {
    for (long i = 0, j = n - 1; i < j; ++i, --j) {
        uint8_t a = codes[i], b = codes[j];
        codes[i] = b < 4 ? 3 - b : b;
        codes[j] = a < 4 ? 3 - a : a;
    }
    if (n & 1) {
        uint8_t m = codes[n / 2];
        codes[n / 2] = m < 4 ? 3 - m : m;
    }
}

// Pack records into a dense padded (rows x max_len) matrix filled with 4.
void pack_rows(const uint8_t* codes, const int64_t* starts, long count,
               uint8_t* out, long max_len) {
    for (long r = 0; r < count; ++r) {
        const int64_t s = starts[r];
        int64_t len = starts[r + 1] - s;
        if (len > max_len) len = max_len;
        uint8_t* row = out + (int64_t)r * max_len;
        memset(row, 4, max_len);
        memcpy(row, codes + s, len);
    }
}

}  // extern "C"
