// Fast free-form inpainting mask rasterizer: the port's own copy of the
// JAX package's native/maskgen.cpp, code unchanged, so that for the same
// seed both draw the same mask bit for bit.
//
// C++ implementation of the RandomMask/RandomBrush algorithm
// (reference: lib/data_factory/ds_ffhq.py:148-225): up to 10 half-size and
// 5 full-size rectangles plus up to 20 polyline brush strokes with circular
// caps, rejection-sampled to a hole-ratio range. Statistically equivalent
// to the PIL path (data/masks.py, the bit-exact oracle of the evaluation
// protocol), not equal to it; it exists so that host-side mask synthesis
// keeps up with the device.
//
// Convention: 1 = known, 0 = hole (uint8).
//
// Built at first use by migan_tpu_torch/data/fast_masks.py:
// g++ -O3 -shared -fPIC -o libmaskgen_<hash>.so maskgen.cpp

#include <cstdint>
#include <cmath>
#include <cstring>
#include <algorithm>

namespace {

struct Rng {
    // xoshiro256** — fast, seedable, reproducible across platforms
    uint64_t s[4];
    explicit Rng(uint64_t seed) {
        // splitmix64 init
        uint64_t z = seed + 0x9e3779b97f4a7c15ULL;
        for (int i = 0; i < 4; i++) {
            z += 0x9e3779b97f4a7c15ULL;
            uint64_t t = z;
            t = (t ^ (t >> 30)) * 0xbf58476d1ce4e5b9ULL;
            t = (t ^ (t >> 27)) * 0x94d049bb133111ebULL;
            s[i] = t ^ (t >> 31);
        }
    }
    static uint64_t rotl(uint64_t x, int k) {
        return (x << k) | (x >> (64 - k));
    }
    uint64_t next() {
        uint64_t r = rotl(s[1] * 5, 7) * 9;
        uint64_t t = s[1] << 17;
        s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3];
        s[2] ^= t; s[3] = rotl(s[3], 45);
        return r;
    }
    double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
    double uniform(double lo, double hi) {
        return lo + (hi - lo) * uniform();
    }
    // randint in [0, n)
    int64_t randint(int64_t n) {
        return n <= 0 ? 0 : (int64_t)(uniform() * n) % n;
    }
    int64_t randint(int64_t lo, int64_t hi) {  // [lo, hi)
        return lo + randint(hi - lo);
    }
    double normal(double mean, double stddev) {
        // Box-Muller
        double u1 = uniform(), u2 = uniform();
        if (u1 < 1e-12) u1 = 1e-12;
        return mean + stddev * std::sqrt(-2.0 * std::log(u1)) *
               std::cos(2.0 * M_PI * u2);
    }
};

inline void fill_disk(uint8_t* m, int s, double cx, double cy, double r) {
    int y0 = std::max(0, (int)std::floor(cy - r));
    int y1 = std::min(s - 1, (int)std::ceil(cy + r));
    double r2 = r * r;
    for (int y = y0; y <= y1; y++) {
        double dy = y - cy;
        double span2 = r2 - dy * dy;
        if (span2 < 0) continue;
        double span = std::sqrt(span2);
        int x0 = std::max(0, (int)std::floor(cx - span));
        int x1 = std::min(s - 1, (int)std::ceil(cx + span));
        for (int x = x0; x <= x1; x++) m[y * s + x] = 0;
    }
}

inline void fill_capsule(uint8_t* m, int s, double x0, double y0,
                         double x1, double y1, double w) {
    // Exact scanline rasterization of a capsule (thick segment with round
    // caps). Convex, so each scanline is a single [xa, xb] interval = the
    // union of the two cap-disk chords and the band chord.
    double r = w * 0.5;
    double dx = x1 - x0, dy = y1 - y0;
    double len2 = dx * dx + dy * dy;
    double len = std::sqrt(len2);
    int ylo = std::max(0, (int)std::floor(std::min(y0, y1) - r));
    int yhi = std::min(s - 1, (int)std::ceil(std::max(y0, y1) + r));
    for (int y = ylo; y <= yhi; y++) {
        double xa = 1e30, xb = -1e30;
        // cap disks
        for (int c = 0; c < 2; c++) {
            double cx = c ? x1 : x0, cy = c ? y1 : y0;
            double d2 = r * r - (y - cy) * (y - cy);
            if (d2 >= 0) {
                double sp = std::sqrt(d2);
                xa = std::min(xa, cx - sp);
                xb = std::max(xb, cx + sp);
            }
        }
        // band: |(x-x0)dy - (y-y0)dx| <= r*len, with t in [0,1]
        if (len > 1e-9) {
            double lo, hi;
            if (std::abs(dy) > 1e-9) {
                double a = ((y - y0) * dx - r * len) / dy + x0;
                double b = ((y - y0) * dx + r * len) / dy + x0;
                lo = std::min(a, b);
                hi = std::max(a, b);
            } else if (std::abs(y - y0) <= r) {
                lo = std::min(x0, x1);
                hi = std::max(x0, x1);
            } else {
                lo = 1e30; hi = -1e30;
            }
            if (lo <= hi) {
                // restrict to the t in [0,1] band between the endpoints
                if (std::abs(dx) > 1e-9) {
                    double txa = x0 - (y - y0) * dy / dx;
                    double txb = x0 + (len2 - (y - y0) * dy) / dx;
                    lo = std::max(lo, std::min(txa, txb));
                    hi = std::min(hi, std::max(txa, txb));
                } else if (y < std::min(y0, y1) || y > std::max(y0, y1)) {
                    lo = 1e30; hi = -1e30;
                }
            }
            if (lo <= hi) {
                xa = std::min(xa, lo);
                xb = std::max(xb, hi);
            }
        }
        if (xa <= xb) {
            int ix0 = std::max(0, (int)std::floor(xa));
            int ix1 = std::min(s - 1, (int)std::ceil(xb));
            if (ix1 >= ix0)
                std::memset(m + (size_t)y * s + ix0, 0, ix1 - ix0 + 1);
        }
    }
}

void random_brush(uint8_t* m, int s, Rng& rng, int max_tries) {
    const int min_num_vertex = 4, max_num_vertex = 18;
    const double mean_angle = 2.0 * M_PI / 5.0;
    const double angle_range = 2.0 * M_PI / 15.0;
    const double min_width = 12, max_width = 48;
    double average_radius = std::sqrt((double)s * s * 2) / 8.0;

    int tries = (int)rng.randint(max_tries);
    for (int t = 0; t < tries; t++) {
        int num_vertex = (int)rng.randint(min_num_vertex, max_num_vertex);
        double amin = mean_angle - rng.uniform(0, angle_range);
        double amax = mean_angle + rng.uniform(0, angle_range);
        double px = (double)rng.randint(s), py = (double)rng.randint(s);
        double width = rng.uniform(min_width, max_width);
        fill_disk(m, s, px, py, width * 0.5);
        for (int i = 0; i < num_vertex; i++) {
            double angle = (i % 2 == 0)
                ? 2.0 * M_PI - rng.uniform(amin, amax)
                : rng.uniform(amin, amax);
            double r = std::clamp(
                rng.normal(average_radius, average_radius / 2.0),
                0.0, 2.0 * average_radius);
            double nx = std::clamp(px + r * std::cos(angle), 0.0, (double)s);
            double ny = std::clamp(py + r * std::sin(angle), 0.0, (double)s);
            fill_capsule(m, s, px, py, nx, ny, width);
            fill_disk(m, s, nx, ny, width * 0.5);
            px = nx; py = ny;
        }
    }
    // final random flips (the reference flips the composed brush)
    if (rng.uniform() > 0.5) {  // flip vertical
        for (int y = 0; y < s / 2; y++)
            for (int x = 0; x < s; x++)
                std::swap(m[y * s + x], m[(s - 1 - y) * s + x]);
    }
    if (rng.uniform() > 0.5) {  // flip horizontal
        for (int y = 0; y < s; y++)
            for (int x = 0; x < s / 2; x++)
                std::swap(m[y * s + x], m[y * s + (s - 1 - x)]);
    }
}

}  // namespace

extern "C" {

// out: s*s uint8 buffer; returns hole ratio achieved.
// 1 = known, 0 = hole.
double generate_mask(uint8_t* out, int s, uint64_t seed,
                     double hole_min, double hole_max) {
    Rng rng(seed);
    double coef = std::min(hole_min + hole_max, 1.0);
    for (int attempt = 0; attempt < 64; attempt++) {
        std::memset(out, 1, (size_t)s * s);
        // rectangles (reference MultiFill)
        int n_half = (int)rng.randint(std::max(1, (int)(10 * coef)));
        for (int i = 0; i < n_half; i++) {
            int w = (int)rng.randint(s / 2), h = (int)rng.randint(s / 2);
            int ww = w / 2, hh = h / 2;
            int x = (int)rng.randint(-ww, s - w + ww);
            int y = (int)rng.randint(-hh, s - h + hh);
            for (int yy = std::max(y, 0); yy < std::min(y + h, s); yy++)
                std::memset(out + yy * s + std::max(x, 0), 0,
                            std::max(0, std::min(x + w, s)
                                     - std::max(x, 0)));
        }
        int n_full = (int)rng.randint(std::max(1, (int)(5 * coef)));
        for (int i = 0; i < n_full; i++) {
            int w = (int)rng.randint(s), h = (int)rng.randint(s);
            int ww = w / 2, hh = h / 2;
            int x = (int)rng.randint(-ww, s - w + ww);
            int y = (int)rng.randint(-hh, s - h + hh);
            for (int yy = std::max(y, 0); yy < std::min(y + h, s); yy++)
                std::memset(out + yy * s + std::max(x, 0), 0,
                            std::max(0, std::min(x + w, s)
                                     - std::max(x, 0)));
        }
        // brush strokes
        random_brush(out, s, rng, std::max(1, (int)(20 * coef)));

        // rejection on hole ratio
        size_t known = 0;
        for (size_t i = 0; i < (size_t)s * s; i++) known += out[i];
        double hole = 1.0 - (double)known / ((double)s * s);
        if (hole > hole_min && hole < hole_max) return hole;
    }
    return -1.0;  // give up; caller falls back
}

// Batched variant: fills n masks of size s*s, seeds seed+i.
void generate_masks(uint8_t* out, int n, int s, uint64_t seed,
                    double hole_min, double hole_max) {
    for (int i = 0; i < n; i++) {
        generate_mask(out + (size_t)i * s * s, s, seed + (uint64_t)i,
                      hole_min, hole_max);
    }
}

}  // extern "C"
