// Native preparation of an extraction tile (models/pipeline.py
// ::extract_from_points): the column statistics of the f64 rows, then their
// centred float32 copy in the padded buffer.
//
// numpy reduces axis 0 of a C-ordered [N, 3] array with an inner loop of
// length 3 a row, so points.mean(axis=0), .min(axis=0) and .max(axis=0) cost
// several times a pass over the rows.  Here pass 1 reads the rows once for
// all three.  Each column's sum starts at the first row's value and adds the
// rows in order, as numpy's add.reduce over axis 0 of a C-ordered array does,
// so sum / n equals points.mean(axis=0) bit for bit; the sum of one column is
// never split.  Pass 2 is elementwise: p - origin rounded to f64, then to
// f32, as (points - origin).astype(np.float32), and zeros in the padding
// rows.  Built with -ffp-contract=off and without -ffast-math, so no sum is
// reassociated and no product is fused.

#include <algorithm>
#include <cstring>
#include <thread>
#include <vector>

namespace {

void centre_rows(const double* p, long long begin, long long end, long long n,
                 const double* origin, float* out) {
    const double o0 = origin[0], o1 = origin[1], o2 = origin[2];
    const long long stop = std::min(end, n);
    for (long long i = begin; i < stop; ++i) {
        const double* r = p + 3 * i;
        float* w = out + 3 * i;
        w[0] = static_cast<float>(r[0] - o0);
        w[1] = static_cast<float>(r[1] - o1);
        w[2] = static_cast<float>(r[2] - o2);
    }
    const long long pad = std::max(begin, n);
    if (end > pad) std::memset(out + 3 * pad, 0, sizeof(float) * 3 * (end - pad));
}

}  // namespace

extern "C" {

// Pass 1 over p[n, 3], n >= 1: out[0:3] the column sums, out[3:6] the
// minima, out[6:9] the maxima.  (A NaN row leaves the sums NaN, which is
// how the caller tells that the minima and maxima are not numpy's.)
void prep_stats(const double* p, long long n, double* out) {
    double s0 = p[0], s1 = p[1], s2 = p[2];
    double l0 = s0, l1 = s1, l2 = s2, h0 = s0, h1 = s1, h2 = s2;
    for (long long i = 1; i < n; ++i) {
        const double x = p[3 * i], y = p[3 * i + 1], z = p[3 * i + 2];
        s0 += x;
        s1 += y;
        s2 += z;
        l0 = x < l0 ? x : l0;
        l1 = y < l1 ? y : l1;
        l2 = z < l2 ? z : l2;
        h0 = x > h0 ? x : h0;
        h1 = y > h1 ? y : h1;
        h2 = z > h2 ? z : h2;
    }
    const double r[9] = {s0, s1, s2, l0, l1, l2, h0, h1, h2};
    std::memcpy(out, r, sizeof(r));
}

// Pass 2: out[cap, 3] f32 gets float(p[i] - origin) for rows [0, n) and
// zeros for rows [n, cap), the rows split evenly over `threads` threads.
void prep_centre(const double* p, long long n, const double* origin, float* out,
                 long long cap, int threads) {
    threads = std::max(1, threads);
    const long long step = (cap + threads - 1) / threads;
    std::vector<std::thread> pool;
    for (int t = 1; t < threads; ++t) {
        const long long b = std::min(cap, t * step), e = std::min(cap, b + step);
        pool.emplace_back(centre_rows, p, b, e, n, origin, out);
    }
    centre_rows(p, 0, std::min(cap, step), n, origin, out);
    for (auto& th : pool) th.join();
}

}  // extern "C"
