// Exact Euclidean distance transform (squared), Felzenszwalb & Huttenlocher
// 2004, separable per-axis lower-envelope passes. Native component backing
// gpmp2_jax.datasets.sdf_gen (the reference uses MATLAB bwdist / scipy
// ndimage for SDF construction: matlab/+gpmp2/signedDistanceField2D.m,
// gpmp2_python/utils/signedDistanceField2D.py:11-45). Build: native/build.py
// -> libgpmp2_edt.so, loaded via ctypes.
//
// API: edt_sq(double* f, long ndim, const long* dims) — in-place transform
// of f (row-major), where f holds 0 at feature (source) voxels and +INF
// elsewhere; on return f holds squared Euclidean cell distances.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

// 1D squared distance transform along a strided line (lower envelope of
// parabolas). Infinite samples (no feature yet on this line) are skipped
// during envelope construction; an all-infinite line stays infinite.
// d, v, z are caller scratch of sizes n, n, n+1; src may alias dst.
void dt1d(double* d, int* v, double* z, int64_t n, int64_t stride,
          const double* src, double* dst) {
  int64_t k = -1;  // empty envelope
  for (int64_t q = 0; q < n; ++q) {
    double fq = src[q * stride];
    if (fq == kInf) continue;
    double s = 0.0;
    while (k >= 0) {
      double fv = src[v[k] * stride];
      s = ((fq + (double)q * q) - (fv + (double)v[k] * v[k])) /
          (2.0 * ((double)q - v[k]));
      if (s <= z[k]) {
        --k;
      } else {
        break;
      }
    }
    if (k < 0) {
      k = 0;
      v[0] = (int)q;
      z[0] = -kInf;
      z[1] = kInf;
    } else {
      ++k;
      v[k] = (int)q;
      z[k] = s;
      z[k + 1] = kInf;
    }
  }
  if (k < 0) {
    for (int64_t q = 0; q < n; ++q) dst[q * stride] = kInf;
    return;
  }
  int64_t j = 0;
  for (int64_t q = 0; q < n; ++q) {
    while (z[j + 1] < (double)q) ++j;
    double dq = (double)q - v[j];
    d[q] = dq * dq + src[v[j] * stride];
  }
  for (int64_t q = 0; q < n; ++q) dst[q * stride] = d[q];
}

}  // namespace

extern "C" {

// In-place exact squared EDT over an ndim row-major array.
void edt_sq(double* f, int64_t ndim, const int64_t* dims) {
  // total elements and strides
  std::vector<int64_t> strides(ndim);
  int64_t total = 1;
  for (int64_t i = ndim - 1; i >= 0; --i) {
    strides[i] = total;
    total *= dims[i];
  }

  for (int64_t axis = 0; axis < ndim; ++axis) {
    int64_t n = dims[axis];
    if (n <= 1) continue;
    int64_t stride = strides[axis];
    int64_t outer = total / n;

    std::vector<double> d(n), z(n + 1);
    std::vector<int> v(n);

    for (int64_t o = 0; o < outer; ++o) {
      // map outer index -> base offset skipping `axis`
      int64_t rem = o, base = 0;
      for (int64_t i = ndim - 1; i >= 0; --i) {
        if (i == axis) continue;
        int64_t idx = rem % dims[i];
        rem /= dims[i];
        base += idx * strides[i];
      }
      dt1d(d.data(), v.data(), z.data(), n, stride, f + base, f + base);
    }
  }
}
}
