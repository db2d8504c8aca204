// Native mesh-topology kernels for fvens_tpu.
//
// The reference implements its entire mesh layer in C++ (FVENS src/mesh/,
// ~3.4k LoC); the JAX rebuild keeps the host topology compiler native where
// per-cell Python loops would dominate setup time on large meshes:
// adjacency coloring (drives the multicolor SGS preconditioner), BFS
// partition growth (domain decomposition), and the element->face incidence
// sweep. Exposed with a C ABI and loaded through ctypes (no pybind11 in the
// image).
//
// Build: g++ -O3 -march=native -shared -fPIC mesh_kernels.cpp -o libfvens_mesh.so

#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

extern "C" {

// Greedy coloring of the cell adjacency graph.
//  nbrs:      (n, maxnf) int32 neighbour ids (may exceed n for ghost slots)
//  nbr_mask:  (n, maxnf) float64, >0 if the neighbour is a real cell
//  active:    (n,) uint8, 1 = color this cell
//  color out: (n,) int64, -1 for inactive
// Returns the number of colors.
int64_t fvens_greedy_coloring(int64_t n, int32_t maxnf,
                              const int32_t* nbrs, const double* nbr_mask,
                              const uint8_t* active, int64_t* color) {
    int64_t ncolors = 0;
    for (int64_t c = 0; c < n; ++c) color[c] = -1;
    std::vector<int64_t> used_stamp(64, -1);
    for (int64_t c = 0; c < n; ++c) {
        if (!active[c]) continue;
        // mark neighbour colors
        for (int32_t k = 0; k < maxnf; ++k) {
            if (nbr_mask[c * maxnf + k] > 0) {
                int64_t nb = nbrs[c * maxnf + k];
                if (nb >= 0 && nb < n && color[nb] >= 0 &&
                    color[nb] < (int64_t)used_stamp.size())
                    used_stamp[color[nb]] = c;
            }
        }
        int64_t col = 0;
        while (col < (int64_t)used_stamp.size() && used_stamp[col] == c)
            ++col;
        color[c] = col;
        if (col + 1 > ncolors) ncolors = col + 1;
    }
    return ncolors < 1 ? 1 : ncolors;
}

// Balanced BFS-growth partition (the reference's Scotch/trivial partitioner
// role, meshpartitioning.cpp:354-461).
//  esuel: (nelem, maxnf) int64 neighbour element or >= nelem/-1 at boundary
//  nfael: (nelem,) int64
//  part out: (nelem,) int64 in [0, nparts)
void fvens_greedy_partition(int64_t nelem, int32_t maxnf,
                            const int64_t* esuel, const int64_t* nfael,
                            int64_t nparts, int64_t* part) {
    for (int64_t i = 0; i < nelem; ++i) part[i] = -1;
    int64_t target = (nelem + nparts - 1) / nparts;
    int64_t seed = 0;
    for (int64_t p = 0; p < nparts; ++p) {
        while (seed < nelem && part[seed] >= 0) ++seed;
        if (seed >= nelem) break;
        std::queue<int64_t> frontier;
        frontier.push(seed);
        int64_t count = 0;
        while (!frontier.empty() && count < target) {
            int64_t c = frontier.front();
            frontier.pop();
            if (part[c] >= 0) continue;
            part[c] = p;
            ++count;
            for (int64_t k = 0; k < nfael[c]; ++k) {
                int64_t nb = esuel[c * maxnf + k];
                if (nb >= 0 && nb < nelem && part[nb] < 0) frontier.push(nb);
            }
        }
    }
    for (int64_t i = 0; i < nelem; ++i)
        if (part[i] < 0) part[i] = nparts - 1;
}

// Greedy strongest-neighbour pairwise matching (one aggregation pass of
// the AMG hierarchy build, solver/multigrid.py). Visit order = index order.
//  nbrs: (n, maxnf) int64 neighbour ids (may exceed n for ghost slots)
//  mask: (n, maxnf) float64 > 0 for real in-range neighbours
//  w:    (n, maxnf) float64 coupling strength
//  agg out: (n,) int64 aggregate id
// Returns number of aggregates.
int64_t fvens_pairwise_aggregate(int64_t n, int32_t maxnf,
                                 const int64_t* nbrs, const double* mask,
                                 const double* w, int64_t* agg) {
    for (int64_t c = 0; c < n; ++c) agg[c] = -1;
    int64_t na = 0;
    for (int64_t c = 0; c < n; ++c) {
        if (agg[c] >= 0) continue;
        int64_t best = -1;
        double bw = 0.0;
        for (int32_t k = 0; k < maxnf; ++k) {
            if (mask[c * maxnf + k] <= 0) continue;
            int64_t nb = nbrs[c * maxnf + k];
            if (nb < 0 || nb >= n || agg[nb] >= 0) continue;
            double wk = w[c * maxnf + k];
            if (wk > bw) { best = nb; bw = wk; }
        }
        agg[c] = na;
        if (best >= 0) agg[best] = na;
        ++na;
    }
    return na;
}

// Element->face incidence for a local (partitioned) cell set.
// For each local cell li (global id allc[li]) and local face slot k:
//   gf = elemface(allc[li], k); lf = gf2lf[gf]
// fills cell_faces (int32), cell_fsign (float64), cell_nbrs (int32),
// nbr_mask (float64), all shaped (n_loc, maxnf) and pre-initialized by the
// caller (faces 0 / sign 0 / self / 0).
void fvens_local_incidence(
    int64_t n_loc, int32_t maxnf, int64_t NCl,
    const int64_t* allc,            // (n_loc,)
    const int64_t* elemface,        // (nelem, maxnf_g) global
    int32_t maxnf_g,
    const int64_t* nfael,           // (nelem,)
    const int64_t* f_left_g,        // (nf_g,) global face left cell
    const int64_t* f_right_g,       // (nf_g,) global face right cell (peri-
                                    // odic-resolved; -1 if none)
    const int64_t* gf2lf,           // (nf_g,) global->local face or -1
    const int64_t* g2l,             // (nelem,) global->local cell or -1
    int64_t nb_g,                   // number of global physical bfaces
    const int64_t* periodic_partner,// (nb_g,) partner bface or -1
    int32_t* cell_faces, double* cell_fsign,
    int32_t* cell_nbrs, double* nbr_mask) {
    for (int64_t li = 0; li < n_loc; ++li) {
        int64_t c = allc[li];
        for (int64_t k = 0; k < nfael[c] && k < maxnf; ++k) {
            int64_t gf = elemface[c * maxnf_g + k];
            if (gf < 0) continue;
            int64_t lf = gf2lf[gf];
            if (lf < 0) continue;
            bool isleft = f_left_g[gf] == c;
            cell_faces[li * maxnf + k] = (int32_t)lf;
            cell_fsign[li * maxnf + k] = isleft ? 1.0 : -1.0;
            if (gf < nb_g) {
                int64_t partner = f_right_g[gf];
                if (periodic_partner[gf] >= 0 && partner >= 0 &&
                    g2l[partner] >= 0) {
                    cell_nbrs[li * maxnf + k] = (int32_t)g2l[partner];
                    nbr_mask[li * maxnf + k] = 1.0;
                } else {
                    cell_nbrs[li * maxnf + k] = (int32_t)(NCl + lf);
                    nbr_mask[li * maxnf + k] = 0.0;
                }
            } else {
                int64_t other = isleft ? f_right_g[gf] : f_left_g[gf];
                int64_t lo = (other >= 0) ? g2l[other] : -1;
                if (lo >= 0) {
                    cell_nbrs[li * maxnf + k] = (int32_t)lo;
                    nbr_mask[li * maxnf + k] = 1.0;
                } else {
                    cell_nbrs[li * maxnf + k] = (int32_t)li;
                    nbr_mask[li * maxnf + k] = 0.0;
                }
            }
        }
    }
}

}  // extern "C"
