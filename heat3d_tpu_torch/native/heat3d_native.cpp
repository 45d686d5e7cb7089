// Native CPU reference stepper of the port (a copy of the JAX package's
// heat3d_native.cpp, so both packages' fp64 oracles run the same loop) —
// the compiled-host-code analogue of the reference's C/C++ driver path
// (SURVEY.md §2 C10: "Host C loop or single-rank run"). Built with OpenMP
// so the golden oracle stays usable at benchmark-scale grids (a pure-NumPy
// float64 sweep of 512^3 is minutes; this is seconds).
//
// Exposed via extern "C" for ctypes (no pybind11 in this image). All
// arrays are C-contiguous. The stepper owns its ghost handling: each step
// fills a (nx+2)(ny+2)(nz+2) padded scratch from the current field per the
// boundary condition, then applies the 3x3x3 update taps to the interior.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline std::int64_t pidx(std::int64_t i, std::int64_t j, std::int64_t k,
                         std::int64_t pny, std::int64_t pnz) {
  return (i * pny + j) * pnz + k;
}

// bc: 0 = dirichlet(bc_value), 1 = periodic
void fill_padded(const double* u, double* up, std::int64_t nx, std::int64_t ny,
                 std::int64_t nz, int bc, double bc_value) {
  const std::int64_t pny = ny + 2, pnz = nz + 2;
#pragma omp parallel for collapse(2)
  for (std::int64_t i = 0; i < nx + 2; ++i) {
    for (std::int64_t j = 0; j < ny + 2; ++j) {
      for (std::int64_t k = 0; k < nz + 2; ++k) {
        std::int64_t si = i - 1, sj = j - 1, sk = k - 1;
        bool inside = si >= 0 && si < nx && sj >= 0 && sj < ny && sk >= 0 &&
                      sk < nz;
        double v;
        if (inside) {
          v = u[(si * ny + sj) * nz + sk];
        } else if (bc == 1) {  // periodic wrap
          si = (si + nx) % nx;
          sj = (sj + ny) % ny;
          sk = (sk + nz) % nz;
          v = u[(si * ny + sj) * nz + sk];
        } else {
          v = bc_value;
        }
        up[pidx(i, j, k, pny, pnz)] = v;
      }
    }
  }
}

void apply_taps(const double* up, double* out, std::int64_t nx,
                std::int64_t ny, std::int64_t nz, const double* taps) {
  const std::int64_t pny = ny + 2, pnz = nz + 2;
#pragma omp parallel for collapse(2)
  for (std::int64_t i = 0; i < nx; ++i) {
    for (std::int64_t j = 0; j < ny; ++j) {
      for (std::int64_t k = 0; k < nz; ++k) {
        double acc = 0.0;
        for (int di = 0; di < 3; ++di)
          for (int dj = 0; dj < 3; ++dj)
            for (int dk = 0; dk < 3; ++dk) {
              const double w = taps[(di * 3 + dj) * 3 + dk];
              if (w != 0.0)
                acc += w * up[pidx(i + di, j + dj, k + dk, pny, pnz)];
            }
        out[(i * ny + j) * nz + k] = acc;
      }
    }
  }
}

}  // namespace

extern "C" {

// Advance `u` (interior field, float64, C-contiguous, shape nx*ny*nz)
// by `steps` explicit-Euler updates in place. taps: 27 float64 update
// weights (3x3x3, C order). Returns 0 on success.
int heat3d_run_f64(double* u, std::int64_t nx, std::int64_t ny,
                   std::int64_t nz, const double* taps, std::int64_t steps,
                   int bc, double bc_value) {
  if (nx < 1 || ny < 1 || nz < 1 || steps < 0) return 1;
  const std::int64_t padded = (nx + 2) * (ny + 2) * (nz + 2);
  std::vector<double> up(padded);
  std::vector<double> next(nx * ny * nz);
  for (std::int64_t s = 0; s < steps; ++s) {
    fill_padded(u, up.data(), nx, ny, nz, bc, bc_value);
    apply_taps(up.data(), next.data(), nx, ny, nz, taps);
    std::memcpy(u, next.data(), sizeof(double) * nx * ny * nz);
  }
  return 0;
}

// L2 norm-squared of (a - b), float64, length n — the residual reduction
// (SURVEY.md §2 C5) for verifying large runs without NumPy temporaries.
double heat3d_diff_sumsq_f64(const double* a, const double* b,
                             std::int64_t n) {
  double acc = 0.0;
#pragma omp parallel for reduction(+ : acc)
  for (std::int64_t i = 0; i < n; ++i) {
    const double d = a[i] - b[i];
    acc += d * d;
  }
  return acc;
}

int heat3d_native_abi_version() { return 1; }

}  // extern "C"
