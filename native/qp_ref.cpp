// Reference dense QP solver (float64, convergence-terminated).
//
// Solves   min 1/2 x^T P x + q^T x   s.t.  A x <= b
// with a Mehrotra predictor-corrector primal-dual interior-point method.
//
// Role in the framework: the MATLAB reference validates its controllers
// against quadprog/Gurobi; this solver is the equivalent ground-truth oracle
// for the batched fixed-iteration solver (ops/qp.py). It runs until
// convergence (not a fixed iteration count), in double precision, with no
// batching -- accuracy over throughput. Exposed to Python via ctypes
// (ops/qp_ref.py).
//
// Build: g++ -O2 -shared -fPIC -o libqpref.so qp_ref.cpp

#include <cmath>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Cholesky factorization in place (lower). Returns 0 on success.
int cholesky(std::vector<double>& M, int n) {
    for (int j = 0; j < n; ++j) {
        double d = M[j * n + j];
        for (int k = 0; k < j; ++k) d -= M[j * n + k] * M[j * n + k];
        if (d <= 0.0) return 1;
        d = std::sqrt(d);
        M[j * n + j] = d;
        for (int i = j + 1; i < n; ++i) {
            double s = M[i * n + j];
            for (int k = 0; k < j; ++k) s -= M[i * n + k] * M[j * n + k];
            M[i * n + j] = s / d;
        }
    }
    return 0;
}

void chol_solve(const std::vector<double>& L, int n, std::vector<double>& x) {
    for (int i = 0; i < n; ++i) {           // forward
        double s = x[i];
        for (int k = 0; k < i; ++k) s -= L[i * n + k] * x[k];
        x[i] = s / L[i * n + i];
    }
    for (int i = n - 1; i >= 0; --i) {      // backward (L^T)
        double s = x[i];
        for (int k = i + 1; k < n; ++k) s -= L[k * n + i] * x[k];
        x[i] = s / L[i * n + i];
    }
}

}  // namespace

extern "C" int qp_solve_ref(int n, int mc, const double* P, const double* q,
                            const double* A, const double* b, double* x_out,
                            double* lam_out, int max_iters, double tol) {
    std::vector<double> x(n, 0.0), s(mc), lam(mc, 1.0);
    std::vector<double> dx(n), ds(mc), dlam(mc), rhs(n);
    std::vector<double> dxa(n), dsa(mc), dlama(mc);
    std::vector<double> M(n * n), r_d(n), r_p(mc);

    // objective scale for the regularizer
    double pmax = 1e-12;
    for (int i = 0; i < n * n; ++i) pmax = std::max(pmax, std::fabs(P[i]));
    const double reg = 1e-12 * pmax;

    for (int i = 0; i < mc; ++i) {
        double Axi = 0.0;                    // A x0 with x0 = 0
        s[i] = std::max(b[i] - Axi, 1.0);
    }

    auto newton = [&](const std::vector<double>& r_slam, std::vector<double>& dx_,
                      std::vector<double>& ds_, std::vector<double>& dlam_) -> int {
        // r_d = P x + q + A^T lam ; r_p = A x + s - b
        for (int i = 0; i < n; ++i) {
            double v = q[i];
            for (int k = 0; k < n; ++k) v += P[i * n + k] * x[k];
            for (int c = 0; c < mc; ++c) v += A[c * n + i] * lam[c];
            r_d[i] = v;
        }
        for (int c = 0; c < mc; ++c) {
            double v = s[c] - b[c];
            for (int k = 0; k < n; ++k) v += A[c * n + k] * x[k];
            r_p[c] = v;
        }
        // M = P + reg I + A^T D A, D = lam/s
        for (int i = 0; i < n; ++i)
            for (int j = 0; j < n; ++j)
                M[i * n + j] = P[i * n + j] + (i == j ? reg : 0.0);
        for (int c = 0; c < mc; ++c) {
            double D = lam[c] / s[c];
            if (D < 1e-14) D = 1e-14;
            if (D > 1e14) D = 1e14;
            for (int i = 0; i < n; ++i) {
                double Ai = A[c * n + i] * D;
                if (Ai == 0.0) continue;
                for (int j = 0; j < n; ++j) M[i * n + j] += Ai * A[c * n + j];
            }
        }
        // rhs = -r_d - A^T ((-r_slam + lam r_p) / s)
        for (int i = 0; i < n; ++i) rhs[i] = -r_d[i];
        for (int c = 0; c < mc; ++c) {
            double w = (-r_slam[c] + lam[c] * r_p[c]) / s[c];
            for (int i = 0; i < n; ++i) rhs[i] -= A[c * n + i] * w;
        }
        if (cholesky(M, n)) return 1;
        dx_ = rhs;
        chol_solve(M, n, dx_);
        for (int c = 0; c < mc; ++c) {
            double Adx = 0.0;
            for (int k = 0; k < n; ++k) Adx += A[c * n + k] * dx_[k];
            ds_[c] = -r_p[c] - Adx;
            dlam_[c] = (-r_slam[c] - lam[c] * ds_[c]) / s[c];
        }
        return 0;
    };

    auto max_step = [&](const std::vector<double>& v, const std::vector<double>& dv) {
        double a = 1.0;
        for (int c = 0; c < mc; ++c)
            if (dv[c] < 0.0) a = std::min(a, -0.99 * v[c] / dv[c]);
        return a;
    };

    std::vector<double> r_slam(mc);
    int it = 0;
    for (; it < max_iters; ++it) {
        double mu = 0.0;
        for (int c = 0; c < mc; ++c) mu += s[c] * lam[c];
        mu /= mc;
        double rp_max = 0.0;
        for (int c = 0; c < mc; ++c) {
            double v = -b[c] + s[c];
            for (int k = 0; k < n; ++k) v += A[c * n + k] * x[k];
            rp_max = std::max(rp_max, std::fabs(v));
        }
        if (mu < tol && rp_max < tol) break;

        for (int c = 0; c < mc; ++c) r_slam[c] = s[c] * lam[c];
        if (newton(r_slam, dxa, dsa, dlama)) return 2;
        double aa = std::min(max_step(s, dsa), max_step(lam, dlama));
        double mua = 0.0;
        for (int c = 0; c < mc; ++c)
            mua += (s[c] + aa * dsa[c]) * (lam[c] + aa * dlama[c]);
        mua /= mc;
        double sigma = mua / (mu + 1e-300);
        sigma = sigma * sigma * sigma;

        for (int c = 0; c < mc; ++c)
            r_slam[c] = s[c] * lam[c] + dsa[c] * dlama[c] - sigma * mu;
        if (newton(r_slam, dx, ds, dlam)) return 2;
        double al = std::min(max_step(s, ds), max_step(lam, dlam));
        for (int i = 0; i < n; ++i) x[i] += al * dx[i];
        for (int c = 0; c < mc; ++c) {
            s[c] += al * ds[c];
            lam[c] += al * dlam[c];
        }
    }

    std::memcpy(x_out, x.data(), n * sizeof(double));
    std::memcpy(lam_out, lam.data(), mc * sizeof(double));
    return it >= max_iters ? 3 : 0;
}
