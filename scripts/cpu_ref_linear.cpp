// Native single-core microbenchmark of the reference's per-step linear
// stack on a REAL exported bench-case Jacobian.
//
// Reproduces the algorithmic content of FVENS's implicit linear solve at
// its shipped settings (testcases/visc-naca0012/opts.solverc,
// testcases/defaults.solverc:10-17):
//   - 4x4-block BSR storage (PETSc MATBAIJ, alinalg.cpp:91-119)
//   - block ILU(0) factorization on the assembled Jacobian (the bjacobi +
//     sub_pc ilu default; single rank => one block = plain ILU0;
//     alinalg.cpp:301-384 installs exactly this class via BLASTed/PETSc)
//   - FGMRES(30), right-preconditioned, rtol 1e-1 on the unpreconditioned
//     residual (the PETSc fgmres defaults the options files select)
//   - component kernels timed separately: BSR SpMV, L/U triangular solves.
//
// This is an independent implementation of textbook algorithms (Saad,
// "Iterative Methods for Sparse Linear Systems": ILU(0) alg 10.4,
// FGMRES alg 9.6) against the reference's *settings*; no reference code
// is used.
//
// Input: the 'FVJ1' binary written by scripts/export_bench_jacobian.py
// (RCM-ordered, pseudo-time term included — the matrix PETSc would see).
// Output: one JSON line with per-kernel walls (best of R repeats) and the
// FGMRES iteration count to rtol.
//
// Build:  g++ -O3 -march=native -funroll-loops -o /tmp/cpu_ref_linear \
//             scripts/cpu_ref_linear.cpp
// Run:    /tmp/cpu_ref_linear /tmp/fvens_jac/naca13k_step040.fvj [repeats]

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <chrono>
#include <cmath>
#include <vector>

using std::size_t;
using clk = std::chrono::steady_clock;

static double now_s() {
    return std::chrono::duration<double>(clk::now().time_since_epoch())
        .count();
}

struct BSR {
    int64_t n = 0, nnzb = 0, bs = 4;
    std::vector<int32_t> indptr, indices;
    std::vector<double> data;   // nnzb * 16, row-major 4x4 blocks
    std::vector<double> rhs;    // n * 4
    std::vector<int32_t> diagp; // position of the diagonal block per row
};

static bool load_fvj(const char *path, BSR &A) {
    FILE *f = std::fopen(path, "rb");
    if (!f) return false;
    int64_t hdr[4];
    if (std::fread(hdr, 8, 4, f) != 4 || hdr[0] != 0x314A5646 ||
        hdr[3] != 4) { std::fclose(f); return false; }
    A.n = hdr[1]; A.nnzb = hdr[2]; A.bs = hdr[3];
    A.indptr.resize(A.n + 1);
    A.indices.resize(A.nnzb);
    A.data.resize(A.nnzb * 16);
    A.rhs.resize(A.n * 4);
    bool ok = std::fread(A.indptr.data(), 4, A.n + 1, f) == (size_t)A.n + 1
        && std::fread(A.indices.data(), 4, A.nnzb, f) == (size_t)A.nnzb
        && std::fread(A.data.data(), 8, A.nnzb * 16, f) == (size_t)A.nnzb * 16
        && std::fread(A.rhs.data(), 8, A.n * 4, f) == (size_t)A.n * 4;
    std::fclose(f);
    if (!ok) return false;
    A.diagp.assign(A.n, -1);
    for (int64_t i = 0; i < A.n; ++i)
        for (int32_t p = A.indptr[i]; p < A.indptr[i + 1]; ++p)
            if (A.indices[p] == i) { A.diagp[i] = p; break; }
    for (int64_t i = 0; i < A.n; ++i)
        if (A.diagp[i] < 0) return false;  // ILU0 needs a full diagonal
    return true;
}

// ---- 4x4 block primitives (the PETSc BAIJ kernel set) ----------------

static inline void b_mv(const double *B, const double *x, double *y) {
    for (int i = 0; i < 4; ++i) {
        double s = 0.0;
        for (int j = 0; j < 4; ++j) s += B[i * 4 + j] * x[j];
        y[i] += s;
    }
}
static inline void b_mv_sub(const double *B, const double *x, double *y) {
    for (int i = 0; i < 4; ++i) {
        double s = 0.0;
        for (int j = 0; j < 4; ++j) s += B[i * 4 + j] * x[j];
        y[i] -= s;
    }
}
// C -= A * B
static inline void b_mm_sub(const double *A, const double *B, double *C) {
    for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) {
            double s = 0.0;
            for (int k = 0; k < 4; ++k) s += A[i * 4 + k] * B[k * 4 + j];
            C[i * 4 + j] -= s;
        }
}
// C = A * B
static inline void b_mm(const double *A, const double *B, double *C) {
    for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) {
            double s = 0.0;
            for (int k = 0; k < 4; ++k) s += A[i * 4 + k] * B[k * 4 + j];
            C[i * 4 + j] = s;
        }
}
// invert a 4x4 block in place (partial-pivot Gauss-Jordan)
static bool b_inv(double *A) {
    double M[4][8];
    for (int i = 0; i < 4; ++i) {
        for (int j = 0; j < 4; ++j) M[i][j] = A[i * 4 + j];
        for (int j = 0; j < 4; ++j) M[i][4 + j] = (i == j) ? 1.0 : 0.0;
    }
    for (int c = 0; c < 4; ++c) {
        int piv = c;
        for (int r = c + 1; r < 4; ++r)
            if (std::fabs(M[r][c]) > std::fabs(M[piv][c])) piv = r;
        if (M[piv][c] == 0.0) return false;
        if (piv != c)
            for (int j = 0; j < 8; ++j) std::swap(M[c][j], M[piv][j]);
        const double d = 1.0 / M[c][c];
        for (int j = 0; j < 8; ++j) M[c][j] *= d;
        for (int r = 0; r < 4; ++r) {
            if (r == c) continue;
            const double m = M[r][c];
            if (m == 0.0) continue;
            for (int j = 0; j < 8; ++j) M[r][j] -= m * M[c][j];
        }
    }
    for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) A[i * 4 + j] = M[i][4 + j];
    return true;
}

// ---- BSR SpMV: y = A x ------------------------------------------------

static void spmv(const BSR &A, const double *x, double *y) {
    for (int64_t i = 0; i < A.n; ++i) {
        double acc[4] = {0, 0, 0, 0};
        for (int32_t p = A.indptr[i]; p < A.indptr[i + 1]; ++p)
            b_mv(&A.data[(size_t)p * 16], &x[(size_t)A.indices[p] * 4], acc);
        std::memcpy(&y[(size_t)i * 4], acc, sizeof acc);
    }
}

// ---- block ILU(0): in-place on a copy of the values --------------------
// Row-wise IKJ variant (Saad alg 10.4, blocks): for each row i, for each
// k in cols(i) with k < i (ascending): A_ik <- A_ik * inv(D_k); then for
// j in cols(i), j > k present in row k's pattern: A_ij -= A_ik * A_kj.
// Diagonal blocks are stored INVERTED afterwards (like PETSc BAIJ ILU).

static void ilu0_factor(const BSR &A, std::vector<double> &F) {
    F = A.data;                           // values copy; pattern shared
    std::vector<int32_t> startj(A.n);     // scratch: row k scan position
    for (int64_t i = 0; i < A.n; ++i) {
        const int32_t rb = A.indptr[i], re = A.indptr[i + 1];
        for (int32_t p = rb; p < re; ++p) {
            const int32_t k = A.indices[p];
            if (k >= i) break;            // columns sorted: lower part done
            // A_ik *= inv(D_k)  (D_k already inverted)
            double tmp[16];
            b_mm(&F[(size_t)p * 16], &F[(size_t)A.diagp[k] * 16], tmp);
            std::memcpy(&F[(size_t)p * 16], tmp, sizeof tmp);
            // fold into the remaining blocks of row i present in row k
            int32_t q = A.diagp[k] + 1;   // row k entries with col > k
            const int32_t qe = A.indptr[k + 1];
            for (int32_t r = p + 1; r < re && q < qe; ++r) {
                const int32_t j = A.indices[r];
                while (q < qe && A.indices[q] < j) ++q;
                if (q < qe && A.indices[q] == j)
                    b_mm_sub(tmp, &F[(size_t)q * 16], &F[(size_t)r * 16]);
            }
        }
        b_inv(&F[(size_t)A.diagp[i] * 16]);   // store D_i^{-1}
    }
    (void)startj;
}

// ---- ILU0 apply: z = U^{-1} L^{-1} r -----------------------------------

static void ilu0_apply(const BSR &A, const std::vector<double> &F,
                       const double *r, double *z) {
    // forward solve L z = r (unit block diagonal)
    for (int64_t i = 0; i < A.n; ++i) {
        double acc[4] = {r[i * 4], r[i * 4 + 1], r[i * 4 + 2], r[i * 4 + 3]};
        for (int32_t p = A.indptr[i]; A.indices[p] < i; ++p)
            b_mv_sub(&F[(size_t)p * 16], &z[(size_t)A.indices[p] * 4], acc);
        std::memcpy(&z[(size_t)i * 4], acc, sizeof acc);
    }
    // backward solve U z = z  (diag stored inverted)
    for (int64_t i = A.n - 1; i >= 0; --i) {
        double acc[4];
        std::memcpy(acc, &z[(size_t)i * 4], sizeof acc);
        for (int32_t p = A.diagp[i] + 1; p < A.indptr[i + 1]; ++p)
            b_mv_sub(&F[(size_t)p * 16], &z[(size_t)A.indices[p] * 4], acc);
        double out[4] = {0, 0, 0, 0};
        b_mv(&F[(size_t)A.diagp[i] * 16], acc, out);
        std::memcpy(&z[(size_t)i * 4], out, sizeof out);
    }
}

// ---- FGMRES(m), right-preconditioned, unpreconditioned-residual rtol ---

struct GmresResult { int iters; double relres; };

static GmresResult fgmres(const BSR &A, const std::vector<double> &F,
                          const double *b, double *x, int m, int maxit,
                          double rtol) {
    const size_t N = (size_t)A.n * 4;
    std::vector<double> r(N), w(N);
    std::vector<std::vector<double>> V(m + 1, std::vector<double>(N));
    std::vector<std::vector<double>> Z(m, std::vector<double>(N));
    std::vector<double> H((m + 1) * m, 0.0), cs(m), sn(m), g(m + 1);
    std::memset(x, 0, N * 8);

    double bnorm = 0.0;
    for (size_t i = 0; i < N; ++i) bnorm += b[i] * b[i];
    bnorm = std::sqrt(bnorm);
    if (bnorm == 0.0) return {0, 0.0};

    int total = 0;
    double relres = 1.0;
    while (total < maxit) {
        // r = b - A x
        spmv(A, x, r.data());
        for (size_t i = 0; i < N; ++i) r[i] = b[i] - r[i];
        double beta = 0.0;
        for (size_t i = 0; i < N; ++i) beta += r[i] * r[i];
        beta = std::sqrt(beta);
        relres = beta / bnorm;
        if (relres <= rtol) break;
        for (size_t i = 0; i < N; ++i) V[0][i] = r[i] / beta;
        std::fill(g.begin(), g.end(), 0.0);
        g[0] = beta;
        int j = 0;
        for (; j < m && total < maxit; ++j, ++total) {
            ilu0_apply(A, F, V[j].data(), Z[j].data());
            spmv(A, Z[j].data(), w.data());
            for (int i = 0; i <= j; ++i) {           // MGS
                double h = 0.0;
                for (size_t t = 0; t < N; ++t) h += w[t] * V[i][t];
                H[i * m + j] = h;
                for (size_t t = 0; t < N; ++t) w[t] -= h * V[i][t];
            }
            double hj = 0.0;
            for (size_t t = 0; t < N; ++t) hj += w[t] * w[t];
            hj = std::sqrt(hj);
            for (int i = 0; i < j; ++i) {            // apply Givens
                const double t = cs[i] * H[i * m + j] + sn[i] * H[(i + 1) * m + j];
                H[(i + 1) * m + j] =
                    -sn[i] * H[i * m + j] + cs[i] * H[(i + 1) * m + j];
                H[i * m + j] = t;
            }
            const double d = std::sqrt(H[j * m + j] * H[j * m + j] + hj * hj);
            cs[j] = H[j * m + j] / d;
            sn[j] = hj / d;
            H[j * m + j] = d;
            g[j + 1] = -sn[j] * g[j];
            g[j] = cs[j] * g[j];
            relres = std::fabs(g[j + 1]) / bnorm;
            if (hj != 0.0)
                for (size_t t = 0; t < N; ++t) V[j + 1][t] = w[t] / hj;
            if (relres <= rtol) { ++j; ++total; break; }
        }
        // back substitution + update
        std::vector<double> y(j, 0.0);
        for (int i = j - 1; i >= 0; --i) {
            double s = g[i];
            for (int k2 = i + 1; k2 < j; ++k2) s -= H[i * m + k2] * y[k2];
            y[i] = s / H[i * m + i];
        }
        for (int i = 0; i < j; ++i)
            for (size_t t = 0; t < N; ++t) x[t] += y[i] * Z[i][t];
        if (relres <= rtol) break;
    }
    return {total, relres};
}

int main(int argc, char **argv) {
    if (argc < 2) {
        std::fprintf(stderr,
                     "usage: %s matrix.fvj [repeats=20] [rtol=0.1]\n",
                     argv[0]);
        return 2;
    }
    const int repeats = argc > 2 ? std::atoi(argv[2]) : 20;
    const double rtol = argc > 3 ? std::atof(argv[3]) : 0.1;
    BSR A;
    if (!load_fvj(argv[1], A)) {
        std::fprintf(stderr, "failed to load %s\n", argv[1]);
        return 1;
    }
    const size_t N = (size_t)A.n * 4;
    std::vector<double> F, x(N), y(N), z(N);

    // --- ILU0 factorization ---
    double t_fact = 1e30;
    for (int r = 0; r < repeats; ++r) {
        const double t0 = now_s();
        ilu0_factor(A, F);
        t_fact = std::min(t_fact, now_s() - t0);
    }

    // sanity: the preconditioned solve must actually reduce the residual
    GmresResult gr = fgmres(A, F, A.rhs.data(), x.data(), 30, 300, rtol);

    // --- FGMRES to rtol (the per-step linear solve) ---
    double t_solve = 1e30;
    for (int r = 0; r < repeats; ++r) {
        const double t0 = now_s();
        gr = fgmres(A, F, A.rhs.data(), x.data(), 30, 300, rtol);
        t_solve = std::min(t_solve, now_s() - t0);
    }

    // --- component kernels ---
    double t_spmv = 1e30, t_tri = 1e30;
    for (int r = 0; r < repeats; ++r) {
        double t0 = now_s();
        spmv(A, x.data(), y.data());
        t_spmv = std::min(t_spmv, now_s() - t0);
        t0 = now_s();
        ilu0_apply(A, F, y.data(), z.data());
        t_tri = std::min(t_tri, now_s() - t0);
    }
    // keep the compiler honest
    double chk = 0.0;
    for (size_t i = 0; i < N; ++i) chk += z[i];

    const double mat_mb = (double)A.nnzb * 16 * 8 / 1e6;
    std::printf(
        "{\"file\": \"%s\", \"n\": %lld, \"nnzb\": %lld, "
        "\"matrix_mb\": %.3f, \"rtol\": %g, "
        "\"t_factor_s\": %.6e, \"t_fgmres_s\": %.6e, "
        "\"fgmres_iters\": %d, \"fgmres_relres\": %.3e, "
        "\"t_spmv_s\": %.6e, \"t_trisolve_s\": %.6e, "
        "\"spmv_gbs\": %.2f, \"trisolve_gbs\": %.2f, "
        "\"repeats\": %d, \"checksum\": %.3e}\n",
        argv[1], (long long)A.n, (long long)A.nnzb, mat_mb, rtol,
        t_fact, t_solve, gr.iters, gr.relres, t_spmv, t_tri,
        mat_mb / 1e3 / t_spmv, mat_mb / 1e3 / t_tri, repeats, chk);
    return 0;
}
