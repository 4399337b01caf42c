// icon_host — native host-side builders for the icon_dvr engine.
//
// The accelerator owns the render path (XLA); these are the host-runtime
// pieces that the reference implements natively (its thread-pool-driven
// accel builds and ingest, ref: common/thread_pool.h, parallel_for.h,
// hostCode.cu:652-701).  They are the dataset-load-time hot spots at
// R2B9 scale (~84M columns): locator binning and majorant-grid
// rasterization.  Exposed through a plain C ABI for ctypes; OpenMP
// parallel where safe.
//
// Build: native/build.sh (g++ -O3 -ffp-contract=off -shared -fPIC
// -fopenmp); icon_dvr/utils/native.py rebuilds it when it is stale.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// Locator binning (grid-of-lists over lat/lon), two-pass rectangle scatter.
//
// The GEOMETRY (lat/lon hulls incl. great-circle edge-bulge extrema, pole
// containment, dateline splits) is computed once in Python
// (icon_dvr.models.locator._range_records) — one source of truth — and
// arrives here as (R, 5) i64 records (cell_id, la0, la1, lb0, lb1) sorted
// by cell id.  Pass 1 counts entries per bin; pass 2 fills a (n_bins, k)
// int32 table, -1 padded, in ascending cell-id order so query ties
// resolve exactly like the brute-force scan.
// ---------------------------------------------------------------------------

// counts: (n_lat*n_lon) int64, zero-initialized by the caller
void ih_locator_count(const int64_t* rec, int64_t n_rec, int n_lon,
                      int64_t* counts) {
  for (int64_t r = 0; r < n_rec; ++r) {
    const int64_t la0 = rec[r * 5 + 1], la1 = rec[r * 5 + 2];
    const int64_t lb0 = rec[r * 5 + 3], lb1 = rec[r * 5 + 4];
    for (int64_t la = la0; la <= la1; ++la)
      for (int64_t lb = lb0; lb <= lb1; ++lb)
        counts[la * n_lon + lb]++;
  }
}

// bins: (n_bins * k) int32 preset to -1; cursors: counts buffer reset to 0
void ih_locator_fill(const int64_t* rec, int64_t n_rec, int n_lon, int k,
                     int64_t* cursors, int32_t* bins) {
  for (int64_t r = 0; r < n_rec; ++r) {  // ascending cell-id order matters
    const int32_t cell = (int32_t)rec[r * 5];
    const int64_t la0 = rec[r * 5 + 1], la1 = rec[r * 5 + 2];
    const int64_t lb0 = rec[r * 5 + 3], lb1 = rec[r * 5 + 4];
    for (int64_t la = la0; la <= la1; ++la)
      for (int64_t lb = lb0; lb <= lb1; ++lb) {
        const int64_t b = la * n_lon + lb;
        bins[b * k + cursors[b]++] = cell;
      }
  }
}

// ---------------------------------------------------------------------------
// Great-circle edge extrema (the geometry feeding _range_records): a cell
// edge's latitude extremum can lie strictly BETWEEN its endpoints (the
// minor arc's closest approach to a pole), so binning by vertex bboxes
// misses sliver regions.  Mirror of the numpy oracle
// icon_dvr.models.locator._edge_extrema (same f64 formula order); the
// per-cell loop avoids the ~10 ns/cell/temporary numpy tax — at R2B9
// (84M cells) this is the difference between ~7 min and seconds of the
// locator build.
//
// Outputs: lat_min/lat_max (n) f64, lon_ext (n, 3) f64 (edge extremum
// lons, vertex-0 lon where no interior extremum), pole (n) i8
// (+1 north pole inside the spherical triangle, -1 south, 0 neither).
// ---------------------------------------------------------------------------

void ih_edge_extrema(const float* lat, const float* lon, int64_t n,
                     double* lat_min, double* lat_max, double* lon_ext,
                     int8_t* pole) {
#pragma omp parallel for schedule(static)
  for (int64_t c = 0; c < n; ++c) {
    const float la32[3] = {lat[c * 3], lat[c * 3 + 1], lat[c * 3 + 2]};
    float lmn = std::min(la32[0], std::min(la32[1], la32[2]));
    float lmx = std::max(la32[0], std::max(la32[1], la32[2]));
    double lo_v = (double)lmn, hi_v = (double)lmx;
    double u[3][3], mm[3][3];
    for (int k = 0; k < 3; ++k) {
      const double la = (double)lat[c * 3 + k];
      const double lo = (double)lon[c * 3 + k];
      const double cl = std::cos(la);
      u[k][0] = cl * std::cos(lo);
      u[k][1] = cl * std::sin(lo);
      u[k][2] = std::sin(la);
      lon_ext[c * 3 + k] = (double)lon[c * 3];  // default: vertex-0 lon
    }
    bool all_le = true, all_ge = true;
    for (int e = 0; e < 3; ++e) {
      const int j = (e + 1) % 3;
      mm[e][0] = u[e][1] * u[j][2] - u[e][2] * u[j][1];
      mm[e][1] = u[e][2] * u[j][0] - u[e][0] * u[j][2];
      mm[e][2] = u[e][0] * u[j][1] - u[e][1] * u[j][0];
      all_le &= (mm[e][2] <= 0.0);
      all_ge &= (mm[e][2] >= 0.0);
    }
    pole[c] = all_le ? 1 : (all_ge ? -1 : 0);
    for (int e = 0; e < 3; ++e) {
      const int i = e, j = (e + 1) % 3;
      const double* m3 = mm[e];
      const double nrm = std::sqrt(m3[0] * m3[0] + m3[1] * m3[1] +
                                   m3[2] * m3[2]);
      const double dn = std::max(nrm, 1e-300);
      const double mz = m3[2] / dn;
      const double zml = std::sqrt(std::max(1.0 - mz * mz, 0.0));
      const double ex = -mz * m3[0] / dn, ey = -mz * m3[1] / dn;
      const double ez = zml * zml;
      const double den = std::max(zml, 1e-300);
      for (int s = 0; s < 2; ++s) {
        const double sign = s ? -1.0 : 1.0;
        const double px = sign * ex / den, py = sign * ey / den,
                     pz = sign * ez / den;
        // interior test: cross(u_i, p).m3 > 0 and cross(p, u_j).m3 > 0
        const double c1 = (u[i][1] * pz - u[i][2] * py) * m3[0] +
                          (u[i][2] * px - u[i][0] * pz) * m3[1] +
                          (u[i][0] * py - u[i][1] * px) * m3[2];
        const double c2 = (py * u[j][2] - pz * u[j][1]) * m3[0] +
                          (pz * u[j][0] - px * u[j][2]) * m3[1] +
                          (px * u[j][1] - py * u[j][0]) * m3[2];
        if (c1 > 0.0 && c2 > 0.0 && zml > 1e-12) {
          const double plat =
              std::asin(std::min(1.0, std::max(-1.0, pz)));
          lo_v = std::min(lo_v, plat);
          hi_v = std::max(hi_v, plat);
          lon_ext[c * 3 + e] = std::atan2(py, px);
        }
      }
    }
    lat_min[c] = lo_v;
    lat_max[c] = hi_v;
  }
}

// ---------------------------------------------------------------------------
// Majorant-grid rasterization: scatter (val_lo, val_hi) min/max into every
// bin of per-item index boxes (the reference's rasterizeBox/buildShell CAS
// atomics, ref: hostCode.cu:227-336, as plain scatter — builds are
// single-writer here).
// ---------------------------------------------------------------------------

void ih_rasterize_ranges(const int64_t* lo_idx, const int64_t* up_idx,
                         const float* val_lo, const float* val_hi,
                         int64_t n_items, int64_t dx, int64_t dy, int64_t dz,
                         float* vr_lo, float* vr_hi) {
  for (int64_t i = 0; i < n_items; ++i) {
    const int64_t x0 = lo_idx[i * 3], y0 = lo_idx[i * 3 + 1], z0 = lo_idx[i * 3 + 2];
    const int64_t x1 = up_idx[i * 3], y1 = up_idx[i * 3 + 1], z1 = up_idx[i * 3 + 2];
    const float vl = val_lo[i], vh = val_hi[i];
    for (int64_t z = z0; z <= z1; ++z)
      for (int64_t y = y0; y <= y1; ++y) {
        float* plo = vr_lo + (z * dx * dy + y * dx);
        float* phi = vr_hi + (z * dx * dy + y * dx);
        for (int64_t x = x0; x <= x1; ++x) {
          if (vl < plo[x]) plo[x] = vl;
          if (vh > phi[x]) phi[x] = vh;
        }
      }
  }
}

// ---------------------------------------------------------------------------
// Dataset ingest helpers: lat/lon crop mask + bounds/data-range scan
// (ref: hostCode.cu:741-808) — single pass over the raw records.
// ---------------------------------------------------------------------------

void ih_crop_mask(const float* lat, const float* lon, int64_t n_cells,
                  float lat_lo, float lat_hi, float lon_lo, float lon_hi,
                  uint8_t* keep) {
#pragma omp parallel for
  for (int64_t i = 0; i < n_cells; ++i) {
    bool ok = true;
    for (int k = 0; k < 3; ++k) {
      const float la = lat[i * 3 + k], lo = lon[i * 3 + k];
      ok &= (la >= lat_lo) & (la <= lat_hi) & (lo >= lon_lo) & (lo <= lon_hi);
    }
    keep[i] = ok ? 1 : 0;
  }
}

int ih_version() { return 1; }

}  // extern "C"
