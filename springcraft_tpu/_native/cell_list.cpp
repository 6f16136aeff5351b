// Spatial cell-list neighbor search producing a boolean adjacency matrix.
//
// Native equivalent of the neighbor search the reference
// delegates to biotite.structure.CellList (used at reference
// interaction.py:155-159).  This is the *host-side* path, used when a
// sparse/host adjacency is explicitly requested (use_cell_list=True on the
// numpy backend); the device compute path instead uses a dense tiled distance
// mask (see springcraft_tpu/ops).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libcell_list.so cell_list.cpp
//
// Semantics match brute force exactly: adjacency[i, j] = (d^2(i, j) <=
// cutoff^2), including the diagonal (callers clear it).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

extern "C" {

// coords: (n, 3) float64, row-major.
// out:    (n, n) uint8 adjacency, written as 0/1.
void adjacency_matrix(const double* coords, int64_t n, double cutoff,
                      uint8_t* out) {
    std::memset(out, 0, static_cast<size_t>(n) * static_cast<size_t>(n));
    if (n == 0) return;
    const double sq_cutoff = cutoff * cutoff;

    // Bounding box
    double lo[3], hi[3];
    for (int d = 0; d < 3; ++d) { lo[d] = coords[d]; hi[d] = coords[d]; }
    for (int64_t i = 1; i < n; ++i) {
        for (int d = 0; d < 3; ++d) {
            double v = coords[3 * i + d];
            lo[d] = std::min(lo[d], v);
            hi[d] = std::max(hi[d], v);
        }
    }

    // Grid with cell edge = cutoff
    int64_t dims[3];
    for (int d = 0; d < 3; ++d) {
        double extent = hi[d] - lo[d];
        dims[d] = std::max<int64_t>(1, static_cast<int64_t>(extent / cutoff) + 1);
    }
    const int64_t n_cells = dims[0] * dims[1] * dims[2];

    auto cell_of = [&](int64_t i, int64_t* c) {
        for (int d = 0; d < 3; ++d) {
            int64_t idx = static_cast<int64_t>((coords[3 * i + d] - lo[d]) / cutoff);
            c[d] = std::min(std::max<int64_t>(idx, 0), dims[d] - 1);
        }
    };

    // Counting sort of atoms into cells
    std::vector<int64_t> cell_index(n);
    std::vector<int64_t> counts(n_cells + 1, 0);
    for (int64_t i = 0; i < n; ++i) {
        int64_t c[3];
        cell_of(i, c);
        int64_t flat = (c[0] * dims[1] + c[1]) * dims[2] + c[2];
        cell_index[i] = flat;
        counts[flat + 1]++;
    }
    for (int64_t c = 0; c < n_cells; ++c) counts[c + 1] += counts[c];
    std::vector<int64_t> order(n);
    {
        std::vector<int64_t> cursor(counts.begin(), counts.end() - 1);
        for (int64_t i = 0; i < n; ++i) order[cursor[cell_index[i]]++] = i;
    }

    // For each atom, scan the 27 neighboring cells
    #pragma omp parallel for schedule(dynamic, 64)
    for (int64_t i = 0; i < n; ++i) {
        int64_t c[3];
        cell_of(i, c);
        const double xi = coords[3 * i], yi = coords[3 * i + 1],
                     zi = coords[3 * i + 2];
        uint8_t* row = out + i * n;
        for (int64_t dx = -1; dx <= 1; ++dx) {
            int64_t cx = c[0] + dx;
            if (cx < 0 || cx >= dims[0]) continue;
            for (int64_t dy = -1; dy <= 1; ++dy) {
                int64_t cy = c[1] + dy;
                if (cy < 0 || cy >= dims[1]) continue;
                for (int64_t dz = -1; dz <= 1; ++dz) {
                    int64_t cz = c[2] + dz;
                    if (cz < 0 || cz >= dims[2]) continue;
                    int64_t flat = (cx * dims[1] + cy) * dims[2] + cz;
                    for (int64_t k = counts[flat]; k < counts[flat + 1]; ++k) {
                        int64_t j = order[k];
                        double ddx = coords[3 * j] - xi;
                        double ddy = coords[3 * j + 1] - yi;
                        double ddz = coords[3 * j + 2] - zi;
                        if (ddx * ddx + ddy * ddy + ddz * ddz <= sq_cutoff) {
                            row[j] = 1;
                        }
                    }
                }
            }
        }
    }
}

// Cell-list neighbor PAIR enumeration: writes pairs (i < j) with
// d^2(i, j) <= cutoff^2 into i_out/j_out (capacity `cap`) and returns the
// TOTAL number of such pairs.  If the return value exceeds `cap`, only the
// first `cap` pairs were written — the caller re-allocates and calls again.
// This is the O(pairs) host-side representation behind the float64
// refinement path (the adjacency-matrix form above is O(n^2) and cannot
// reach the matrix-free regime).
int64_t neighbor_pairs(const double* coords, int64_t n, double cutoff,
                       int64_t* i_out, int64_t* j_out, int64_t cap) {
    if (n == 0) return 0;
    const double sq_cutoff = cutoff * cutoff;

    double lo[3], hi[3];
    for (int d = 0; d < 3; ++d) { lo[d] = coords[d]; hi[d] = coords[d]; }
    for (int64_t i = 1; i < n; ++i) {
        for (int d = 0; d < 3; ++d) {
            double v = coords[3 * i + d];
            lo[d] = std::min(lo[d], v);
            hi[d] = std::max(hi[d], v);
        }
    }
    int64_t dims[3];
    for (int d = 0; d < 3; ++d) {
        double extent = hi[d] - lo[d];
        dims[d] = std::max<int64_t>(1, static_cast<int64_t>(extent / cutoff) + 1);
    }
    const int64_t n_cells = dims[0] * dims[1] * dims[2];

    auto cell_of = [&](int64_t i, int64_t* c) {
        for (int d = 0; d < 3; ++d) {
            int64_t idx = static_cast<int64_t>((coords[3 * i + d] - lo[d]) / cutoff);
            c[d] = std::min(std::max<int64_t>(idx, 0), dims[d] - 1);
        }
    };

    std::vector<int64_t> cell_index(n);
    std::vector<int64_t> counts(n_cells + 1, 0);
    for (int64_t i = 0; i < n; ++i) {
        int64_t c[3];
        cell_of(i, c);
        int64_t flat = (c[0] * dims[1] + c[1]) * dims[2] + c[2];
        cell_index[i] = flat;
        counts[flat + 1]++;
    }
    for (int64_t c = 0; c < n_cells; ++c) counts[c + 1] += counts[c];
    std::vector<int64_t> order(n);
    {
        std::vector<int64_t> cursor(counts.begin(), counts.end() - 1);
        for (int64_t i = 0; i < n; ++i) order[cursor[cell_index[i]]++] = i;
    }

    int64_t total = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t c[3];
        cell_of(i, c);
        const double xi = coords[3 * i], yi = coords[3 * i + 1],
                     zi = coords[3 * i + 2];
        for (int64_t dx = -1; dx <= 1; ++dx) {
            int64_t cx = c[0] + dx;
            if (cx < 0 || cx >= dims[0]) continue;
            for (int64_t dy = -1; dy <= 1; ++dy) {
                int64_t cy = c[1] + dy;
                if (cy < 0 || cy >= dims[1]) continue;
                for (int64_t dz = -1; dz <= 1; ++dz) {
                    int64_t cz = c[2] + dz;
                    if (cz < 0 || cz >= dims[2]) continue;
                    int64_t flat = (cx * dims[1] + cy) * dims[2] + cz;
                    for (int64_t p = counts[flat]; p < counts[flat + 1]; ++p) {
                        int64_t j = order[p];
                        if (j <= i) continue;
                        double ddx = coords[3 * j] - xi;
                        double ddy = coords[3 * j + 1] - yi;
                        double ddz = coords[3 * j + 2] - zi;
                        if (ddx * ddx + ddy * ddy + ddz * ddz <= sq_cutoff) {
                            if (total < cap) {
                                i_out[total] = i;
                                j_out[total] = j;
                            }
                            ++total;
                        }
                    }
                }
            }
        }
    }
    return total;
}

// Float64 ANM Hessian apply from a pair list: out = H @ v with
//   (H v)_i = sum_j g_ij * d_ij * (d_ij . (v_i - v_j)),  g_ij = k_ij / d^2.
// v and out are (n, 3, k) row-major float64; out is overwritten.
// This is the hot kernel of the f64 Rayleigh-Ritz refinement
// (ops/modes.py) — O(pairs * k) instead of the O(n^2 * k) dense panel
// stream, and the only float64 compute path that scales to the
// matrix-free regime on the host.
void enm_hv_pairs(const double* coords, int64_t n,
                  const int64_t* pi, const int64_t* pj, const double* g,
                  int64_t npairs, const double* v, int64_t k, double* out) {
    std::memset(out, 0, sizeof(double) * static_cast<size_t>(n) * 3 * k);
    for (int64_t p = 0; p < npairs; ++p) {
        const int64_t i = pi[p], j = pj[p];
        const double dx = coords[3 * i] - coords[3 * j];
        const double dy = coords[3 * i + 1] - coords[3 * j + 1];
        const double dz = coords[3 * i + 2] - coords[3 * j + 2];
        const double gg = g[p];
        const double* vi = v + i * 3 * k;
        const double* vj = v + j * 3 * k;
        double* oi = out + i * 3 * k;
        double* oj = out + j * 3 * k;
        for (int64_t c = 0; c < k; ++c) {
            const double s = gg * (dx * (vi[c] - vj[c])
                                   + dy * (vi[k + c] - vj[k + c])
                                   + dz * (vi[2 * k + c] - vj[2 * k + c]));
            const double t0 = dx * s, t1 = dy * s, t2 = dz * s;
            oi[c] += t0;         oi[k + c] += t1;     oi[2 * k + c] += t2;
            oj[c] -= t0;         oj[k + c] -= t1;     oj[2 * k + c] -= t2;
        }
    }
}

// Float64 GNM Kirchhoff apply from a pair list: out = K @ v with
//   (K v)_i = sum_j k_ij * (v_i - v_j).
// v and out are (n, k) row-major float64; out is overwritten.
void gnm_kv_pairs(const int64_t* pi, const int64_t* pj, const double* kv,
                  int64_t npairs, int64_t n, const double* v, int64_t k,
                  double* out) {
    std::memset(out, 0, sizeof(double) * static_cast<size_t>(n) * k);
    for (int64_t p = 0; p < npairs; ++p) {
        const int64_t i = pi[p], j = pj[p];
        const double kk = kv[p];
        const double* vi = v + i * k;
        const double* vj = v + j * k;
        double* oi = out + i * k;
        double* oj = out + j * k;
        for (int64_t c = 0; c < k; ++c) {
            const double t = kk * (vi[c] - vj[c]);
            oi[c] += t;
            oj[c] -= t;
        }
    }
}

// Fast fixed-column PDB ATOM/HETATM coordinate extraction.
// lines: concatenated, newline-separated text. Returns number of atom
// records parsed; fills coord (cap*3 doubles).
int64_t parse_pdb_coords(const char* text, int64_t text_len, double* coord,
                         int64_t cap) {
    int64_t count = 0;
    const char* p = text;
    const char* end = text + text_len;
    while (p < end && count < cap) {
        const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
        int64_t len = (nl ? nl - p : end - p);
        if (len >= 54 &&
            ((strncmp(p, "ATOM  ", 6) == 0) || (strncmp(p, "HETATM", 6) == 0))) {
            char buf[9];
            for (int f = 0; f < 3; ++f) {
                std::memcpy(buf, p + 30 + 8 * f, 8);
                buf[8] = '\0';
                coord[3 * count + f] = std::strtod(buf, nullptr);
            }
            ++count;
        }
        if (!nl) break;
        p = nl + 1;
    }
    return count;
}

}  // extern "C"
