// Native encoder of compress's downsampled LAS (models/pipeline.py::compress):
// the voxel output's kept rows straight into the file's point records.
//
// numpy builds the same bytes in io/las.py's make_las + write_las: the kept
// f32 rows widened to f64 plus the tile's origin, (p - offset) / scale
// rounded half to even (np.round), refused beyond int32, X, Y, Z as
// little-endian int32 at the head of a zeroed record, and the header's
// bounds as the minima and maxima of record * scale + offset.  That is a
// dozen passes and temporaries over the rows; here each row is read once and
// its record written once.  The rows are split over threads; a thread's
// first record is the kept count before its range, so the bytes do not
// depend on the number of threads, and minima and maxima combine exactly.
// Built with -ffp-contract=off and without -ffast-math, so no product is
// fused into a sum and every step rounds as numpy's does.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__, "LAS records are little-endian");

namespace {

struct Part {
    long long begin, end;  // rows [begin, end)
    long long kept, first;  // kept rows among them, index of their first record
    double lo[3], hi[3];
    bool fits;  // every record within int32
};

void count_kept(const unsigned char* keep, Part* p) {
    long long k = 0;
    for (long long i = p->begin; i < p->end; ++i) k += keep[i] != 0;
    p->kept = k;
}

void encode_rows(const float* rows, const unsigned char* keep, const double* origin,
                 const double* scale, const double* offset, unsigned char* out,
                 long long record_len, Part* p) {
    unsigned char* w = out + p->first * record_len;
    bool fits = true;
    for (int j = 0; j < 3; ++j) {
        p->lo[j] = INFINITY;
        p->hi[j] = -INFINITY;
    }
    for (long long i = p->begin; i < p->end; ++i) {
        if (!keep[i]) continue;
        int32_t rec[3];
        for (int j = 0; j < 3; ++j) {
            const double v = static_cast<double>(rows[3 * i + j]) + origin[j];
            const double q = std::nearbyint((v - offset[j]) / scale[j]);
            if (!(std::fabs(q) <= 2147483647.0)) {  // a NaN too
                fits = false;
                rec[j] = 0;
                continue;
            }
            rec[j] = static_cast<int32_t>(q);
            // from the int32, as write_las decodes it: never -0.0
            const double d = static_cast<double>(rec[j]) * scale[j] + offset[j];
            p->lo[j] = d < p->lo[j] ? d : p->lo[j];
            p->hi[j] = d > p->hi[j] ? d : p->hi[j];
        }
        std::memcpy(w, rec, 12);
        std::memset(w + 12, 0, record_len - 12);
        w += record_len;
    }
    p->fits = fits;
}

template <class F>
void on_threads(std::vector<Part>& parts, F f) {
    std::vector<std::thread> pool;
    for (size_t t = 1; t < parts.size(); ++t) pool.emplace_back(f, &parts[t]);
    f(&parts[0]);
    for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// rows f32[cap, 3], keep bool[cap]: out[n * record_len] gets one record a
// kept row, in row order (record_len >= 12, n the kept rows); bounds[0:3]
// the minima and bounds[3:6] the maxima of the decoded coordinates.
// Returns n, or -1 when a record falls outside int32 or is NaN (make_las
// raises for the first; a NaN comes from no voxel row of integer records).
long long las_encode_rows(const float* rows, const unsigned char* keep, long long cap,
                          const double* origin, const double* scale, const double* offset,
                          unsigned char* out, long long record_len, int threads,
                          double* bounds) {
    threads = static_cast<int>(std::max(1LL, std::min<long long>(threads, cap)));
    const long long step = (cap + threads - 1) / threads;
    std::vector<Part> parts(threads);
    for (int t = 0; t < threads; ++t) {
        parts[t].begin = std::min(cap, t * step);
        parts[t].end = std::min(cap, parts[t].begin + step);
    }
    on_threads(parts, [keep](Part* p) { count_kept(keep, p); });
    long long total = 0;
    for (auto& p : parts) {
        p.first = total;
        total += p.kept;
    }
    on_threads(parts, [=](Part* p) {
        encode_rows(rows, keep, origin, scale, offset, out, record_len, p);
    });
    bool fits = true;
    double lo[3] = {0, 0, 0}, hi[3] = {0, 0, 0};
    bool any = false;
    for (auto& p : parts) {
        fits = fits && p.fits;
        if (p.kept == 0) continue;
        for (int j = 0; j < 3; ++j) {
            lo[j] = any && lo[j] <= p.lo[j] ? lo[j] : p.lo[j];
            hi[j] = any && hi[j] >= p.hi[j] ? hi[j] : p.hi[j];
        }
        any = true;
    }
    if (!fits) return -1;
    std::memcpy(bounds, lo, sizeof(lo));
    std::memcpy(bounds + 3, hi, sizeof(hi));
    return total;
}

}  // extern "C"
