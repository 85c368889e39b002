// The ASCII bodies of a VTU file's DataArrays, in one pass over each array:
// every value as printf("%.12g") (Float64) or as a decimal integer (Int32,
// UInt8), separated by single spaces, with no separator at the end.  The
// bytes are those of Python's " ".join(f"{v:.12g}" for v in values), which
// `mesh/io_vtu.py` writes where this library cannot be built; in particular
// a NaN is "nan" whatever its sign, as Python writes it.
//
// A host library with a plain C interface, built with g++ -O3 -std=c++17
// by ops/cuda_build.py and loaded with ctypes.
//
// The general formatter is std::to_chars(..., chars_format::general, 12),
// which the standard defines as printf's %.12g in the C locale: correctly
// rounded, ties to even, as Python's format().  It takes ~140 ns a value.
// A value with 2^-36 <= |v| < 2^37 (1.5e-11 to 1.4e11), the usual range of a
// frame's fields, takes a shorter route to the same bytes, in exact integer
// arithmetic:
//
//   v = m 2^q with m < 2^53 an integer and q < 0, and X = floor(log10 |v|).
//   The 12 significant digits of %.12g are m 10^k / 2^-q, k = 11 - X, to
//   the nearest integer, ties to even: with 1 <= k <= 22, m 10^k < 2^127 is
//   an exact unsigned 128-bit product, and the quotient, its remainder and
//   the tie are read off the low -q bits.  A carry to 1e12 moves X up by
//   one.  X is first taken from the binary exponent, floor(log10 2^(e-1)),
//   which is X or one below it; a quotient of 13 digits says it was below.
//   The digits are then laid out as %g lays them out: fixed notation for
//   -4 <= X < 12, else d.ddde+XX; trailing zeros and a bare point dropped.

#include <charconv>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kPrecision = 12;
constexpr uint64_t kHigh = 1000000000000ULL;  // 1e12

using u128 = unsigned __int128;

// 10^k for k <= 22, below 2^74
struct Pow10 {
    u128 p[23];
    constexpr Pow10() : p() {
        u128 x = 1;
        for (int k = 0; k < 23; ++k) {
            p[k] = x;
            x *= 10;
        }
    }
};
constexpr Pow10 kPow10;

char* general(char* p, double v) {
    return std::to_chars(p, p + 32, v, std::chars_format::general, kPrecision).ptr;
}

// m 10^k / 2^s to the nearest integer, ties to even
uint64_t rounded(uint64_t m, int k, int s) {
    const u128 n = u128(m) * kPow10.p[k];
    const uint64_t whole = static_cast<uint64_t>(n >> s);
    const u128 rem = n & ((u128(1) << s) - 1);
    const u128 half = u128(1) << (s - 1);
    return whole + (rem > half || (rem == half && (whole & 1)));
}

// the six decimal digits of u < 10^6, two at a time
void put_six(char* p, uint32_t u) {
    static constexpr char kPairs[] =
        "00010203040506070809101112131415161718192021222324252627282930313233343536373839"
        "40414243444546474849505152535455565758596061626364656667686970717273747576777879"
        "8081828384858687888990919293949596979899";
    const uint32_t a = u / 10000, b = u / 100 % 100, c = u % 100;
    std::memcpy(p, kPairs + 2 * a, 2);
    std::memcpy(p + 2, kPairs + 2 * b, 2);
    std::memcpy(p + 4, kPairs + 2 * c, 2);
}

char* put_exponent(char* p, int x) {
    *p++ = 'e';
    *p++ = x < 0 ? '-' : '+';
    unsigned u = x < 0 ? -x : x;
    if (u >= 100) *p++ = static_cast<char>('0' + u / 100);
    *p++ = static_cast<char>('0' + u / 10 % 10);
    *p++ = static_cast<char>('0' + u % 10);
    return p;
}

char* format(char* p, double v) {
    uint64_t bits;
    std::memcpy(&bits, &v, 8);
    const int biased = static_cast<int>(bits >> 52 & 0x7ff);
    if (biased == 0x7ff && (bits & ((uint64_t(1) << 52) - 1))) {
        std::memcpy(p, "nan", 3);
        return p + 3;
    }
    const int e = biased - 1022;  // 2^(e-1) <= |v| < 2^e where v is normal
    int x = ((e - 1) * 78913) >> 18;  // floor(log10 2^(e-1)), for |e| < 1600
    const int k = kPrecision - 1 - x;
    // -11 <= x <= 10, that is -35 <= e <= 37; the rest, zeros, subnormals
    // and infinities among them, take the general formatter
    if (k < 1 || k > 22) return general(p, v);
    const uint64_t m = (bits & ((uint64_t(1) << 52) - 1)) | (uint64_t(1) << 52);
    const int s = 53 - e;  // |v| = m / 2^s, 16 <= s <= 88
    uint64_t d = rounded(m, k, s);
    if (d >= kHigh) {  // X = x + 1; a carry of the first try rounds the same
        ++x;
        d = rounded(m, k - 1, s);
    }
    if (d >= kHigh) {
        d /= 10;
        ++x;
    }

    char digits[kPrecision];
    put_six(digits, static_cast<uint32_t>(d / 1000000));
    put_six(digits + 6, static_cast<uint32_t>(d % 1000000));
    int n = kPrecision;  // significant digits once trailing zeros are dropped
    while (n > 1 && digits[n - 1] == '0') --n;

    if (bits >> 63) *p++ = '-';
    if (x < -4 || x >= kPrecision) {
        *p++ = digits[0];
        if (n > 1) {
            *p++ = '.';
            std::memcpy(p, digits + 1, n - 1);
            p += n - 1;
        }
        return put_exponent(p, x);
    }
    if (x < 0) {
        *p++ = '0';
        *p++ = '.';
        for (int i = 0; i < -x - 1; ++i) *p++ = '0';
        std::memcpy(p, digits, n);
        return p + n;
    }
    const int whole_digits = x + 1;
    if (n <= whole_digits) {
        std::memcpy(p, digits, n);
        p += n;
        for (int i = n; i < whole_digits; ++i) *p++ = '0';
        return p;
    }
    std::memcpy(p, digits, whole_digits);
    p += whole_digits;
    *p++ = '.';
    std::memcpy(p, digits + whole_digits, n - whole_digits);
    return p + n - whole_digits;
}

}  // namespace

extern "C" {

// Writes the n values of x as "%.12g" separated by single spaces into out,
// which holds at least 25 n bytes (a value takes at most 24 and its
// space); returns the number of bytes written.
int64_t vtu_text_f64(const double* x, int64_t n, char* out) {
    char* p = out;
    for (int64_t i = 0; i < n; ++i) {
        if (i) *p++ = ' ';
        p = format(p, x[i]);
    }
    return p - out;
}

// The same for integers, each in decimal.
int64_t vtu_text_i64(const int64_t* x, int64_t n, char* out) {
    char* p = out;
    for (int64_t i = 0; i < n; ++i) {
        if (i) *p++ = ' ';
        p = std::to_chars(p, p + 24, x[i]).ptr;
    }
    return p - out;
}

}  // extern "C"
