/* Native hot loops for the snapshot CSV codec.
 *
 * The snapshot format is the reference's contract (SnapshotRW.jl) and the
 * particle block dominates the file (N rows x 7 float64 columns). Python
 * and pandas both pay per-value interpreter/format costs here; these two
 * functions do the same work with snprintf("%.17g") and strtod — exact
 * float64 round-trip, parseable by Julia's CSV.read.
 *
 * Built on demand with `cc -O2 -shared -fPIC` and loaded via ctypes
 * (sphtpu_torch/io/native.py); the pure-pandas path remains as fallback.
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>

/* Format n particle rows. data is row-major (n, ncols) with ncols 6 or 7
 * (x y z vx vy vz [K]). Writes "particle,<vals>[,K|,],,,\n" per row into
 * out (capacity cap). Returns bytes written, or -1 on overflow. */
long sph_format_particles(const double *data, long n, long ncols,
                          char *out, long cap) {
    char *p = out;
    char *end = out + cap;
    for (long i = 0; i < n; i++) {
        if (end - p < 512) return -1;
        memcpy(p, "particle", 8);
        p += 8;
        const double *row = data + i * ncols;
        for (long j = 0; j < ncols; j++) {
            *p++ = ',';
            double v = row[j];
            if (fabs(v) < 1e15 && v == (double)(long long)v) {
                /* range check first: double->long long casts of
                 * out-of-range magnitudes (CGS values hit 1e17..1e33)
                 * are undefined behavior in C */
                /* integral floats print compactly but keep the ".0" so the
                 * column stays float-typed for any reader that sniffs */
                p += snprintf(p, 64, "%.1f", v);
            } else {
                p += snprintf(p, 64, "%.17g", v);
            }
        }
        if (ncols == 6) { *p++ = ','; } /* empty K cell */
        *p++ = ','; *p++ = ','; *p++ = ',';  /* rlin, rho_radial, constants */
        *p++ = '\n';
    }
    return (long)(p - out);
}

/* Parse particle rows from buf (len bytes). Each row must start with
 * "particle,". Stores ncols doubles per row into out (capacity
 * max_rows * ncols); an empty trailing K cell stores NaN. Returns rows
 * parsed; stops at the first non-particle line. */
long sph_parse_particles(const char *buf, long len, long ncols,
                         double *out, long max_rows) {
    const char *p = buf;
    const char *end = buf + len;
    long rows = 0;
    while (p < end && rows < max_rows) {
        if (end - p < 9 || memcmp(p, "particle,", 9) != 0) break;
        p += 9;
        double *orow = out + rows * ncols;
        for (long j = 0; j < ncols; j++) {
            if (p < end && (*p == ',' || *p == '\n')) {
                orow[j] = NAN;  /* empty cell (isothermal K column) */
            } else {
                char *q;
                orow[j] = strtod(p, &q);
                p = q;
            }
            if (j + 1 < ncols) {
                if (p < end && *p == ',') p++;
                else return -1;
            }
        }
        /* skip the rest of the line (empty tail cells) */
        while (p < end && *p != '\n') p++;
        if (p < end) p++;
        rows++;
    }
    return rows;
}
