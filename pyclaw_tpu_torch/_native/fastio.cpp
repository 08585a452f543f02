// Native frame writer for the clawpack ascii format (fort.qXXXX).
//
// Copy of the JAX package's pyclaw_tpu/_native/fastio.cpp.  The card
// owns the PDE compute; file IO is host work, and formatting
// O(num_eqn * cells) "%18.8e" fields per frame is the hot loop of the
// output path (reference: src/pyclaw/fileio/ascii.py, the pure-Python
// column loops).  This C++ writer produces output byte-identical to
// pyclaw_tpu_torch/fileio/ascii.py::_write_array (the plain version) and
// to the JAX package's copy of it.
//
// Compiled on first use by pyclaw_tpu_torch/_native/__init__.py:
//   g++ -O2 -shared -fPIC -std=c++17 fastio.cpp -o libclawio.so
// and loaded via ctypes; a failed build raises.

#include <charconv>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

struct Buf {
    FILE *f;
    char *data;
    size_t used, cap;
};

inline void buf_flush(Buf &b) {
    if (b.used) {
        fwrite(b.data, 1, b.used, b.f);
        b.used = 0;
    }
}

inline void buf_putc(Buf &b, char c) {
    if (b.used + 1 > b.cap) buf_flush(b);
    b.data[b.used++] = c;
}

// %18.8e via std::to_chars (Ryu — ~10x faster than glibc snprintf and
// digit-for-digit identical, verified incl. round-to-even, subnormals,
// -0.0, 3-digit exponents, inf/nan) + left-pad to the printf field width.
inline void put_field(Buf &b, double v) {
    char tmp[32];
    char *end = std::to_chars(tmp, tmp + sizeof tmp, v,
                              std::chars_format::scientific, 8).ptr;
    long n = end - tmp;
    long pad = 18 - n;
    for (long s = 0; s < pad; ++s) b.data[b.used++] = ' ';
    memcpy(b.data + b.used, tmp, (size_t)n);
    b.used += (size_t)n;
}

// One cell line: num_eqn space-separated %18.8e fields + newline.
inline void put_cell(Buf &b, const double *q, long num_eqn, long stride,
                     long cell) {
    // each field is <= 25 chars incl. separator (nan/inf shorter)
    if (b.used + 32 * (size_t)num_eqn > b.cap) buf_flush(b);
    for (long m = 0; m < num_eqn; ++m) {
        if (m) b.data[b.used++] = ' ';
        put_field(b, q[m * stride + cell]);
    }
    b.data[b.used++] = '\n';
}

}  // namespace

extern "C" {

// q: C-contiguous (num_eqn, n1, n2, n3) float64 (n2=n3=1 below 3D).
// header: pre-formatted patch header text (written verbatim).
// Layout matches ascii.py::_write_array: first spatial index fastest,
// blank line after each x-pencil in 2D/3D, extra blank per plane in 3D.
// Returns 0 on success, -1 on open failure.
int claw_write_ascii(const char *path, const char *header, const double *q,
                     long num_eqn, long n1, long n2, long n3, long num_dim) {
    FILE *f = fopen(path, "w");
    if (!f) return -1;
    if (header) fputs(header, f);

    const size_t cap = 1 << 20;
    char *data = (char *)malloc(cap);
    if (!data) {
        fclose(f);
        return -1;
    }
    Buf b{f, data, 0, cap};
    const long stride = n1 * n2 * n3;  // per-equation block

    if (num_dim == 1) {
        for (long i = 0; i < n1; ++i) put_cell(b, q, num_eqn, stride, i);
    } else if (num_dim == 2) {
        for (long j = 0; j < n2; ++j) {
            for (long i = 0; i < n1; ++i)
                put_cell(b, q, num_eqn, stride, i * n2 + j);
            buf_putc(b, '\n');
        }
    } else {
        for (long k = 0; k < n3; ++k) {
            for (long j = 0; j < n2; ++j) {
                for (long i = 0; i < n1; ++i)
                    put_cell(b, q, num_eqn, stride, (i * n2 + j) * n3 + k);
                buf_putc(b, '\n');
            }
            buf_putc(b, '\n');
        }
    }
    buf_flush(b);
    free(data);
    fclose(f);
    return 0;
}

}  // extern "C"
