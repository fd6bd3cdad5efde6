// Native geometry kernels for the lowering hot path.
//
// The reference keeps all geometry rasterization in Python/shapely
// (/root/reference/tidy3d/components/geometry/base.py); here the
// per-grid-point polygon tests that dominate host-side lowering of
// polygon-based structures on large grids run as OpenMP C++ kernels.
// Plain C ABI, loaded via ctypes (no pybind11 dependency).

#include <cmath>
#include <cstdint>

extern "C" {

// Even-odd crossing test for npts query points against an nv-gon.
void points_in_polygon(const double* xs, const double* ys, int64_t npts,
                       const double* vx, const double* vy, int64_t nv,
                       uint8_t* out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < npts; ++i) {
        const double x = xs[i];
        const double y = ys[i];
        int inside = 0;
        for (int64_t j = 0, k = nv - 1; j < nv; k = j++) {
            const double y1 = vy[j], y2 = vy[k];
            if ((y1 > y) != (y2 > y)) {
                const double x_int =
                    vx[j] + (y - y1) * (vx[k] - vx[j]) / (y2 - y1);
                if (x < x_int) inside = !inside;
            }
        }
        out[i] = static_cast<uint8_t>(inside);
    }
}

// Signed distance to the polygon boundary (negative inside).
void polygon_sdf(const double* xs, const double* ys, int64_t npts,
                 const double* vx, const double* vy, int64_t nv,
                 double* out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < npts; ++i) {
        const double x = xs[i];
        const double y = ys[i];
        double best = 1e300;
        int inside = 0;
        for (int64_t j = 0, k = nv - 1; j < nv; k = j++) {
            const double ax = vx[j], ay = vy[j];
            const double bx = vx[k], by = vy[k];
            const double abx = bx - ax, aby = by - ay;
            const double len2 = abx * abx + aby * aby;
            double t = 0.0;
            if (len2 > 1e-30) {
                t = ((x - ax) * abx + (y - ay) * aby) / len2;
                t = t < 0.0 ? 0.0 : (t > 1.0 ? 1.0 : t);
            }
            const double dx = x - (ax + t * abx);
            const double dy = y - (ay + t * aby);
            const double d2 = dx * dx + dy * dy;
            if (d2 < best) best = d2;
            if ((ay > y) != (by > y)) {
                const double x_int = ax + (y - ay) * (bx - ax) / (by - ay);
                if (x < x_int) inside = !inside;
            }
        }
        const double d = std::sqrt(best);
        out[i] = inside ? -d : d;
    }
}

}  // extern "C"
