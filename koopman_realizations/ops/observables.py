"""Observable dictionaries: lifted-state basis construction and evaluation.

Re-designs the reference's symbolic dictionary machinery
(``Ksysid.def_observables:455-536``, ``def_polyLift:629-677``,
``def_fourierLift:694-731``, ``def_fourierLift_sparser:734-767``,
``def_gaussianLift:790-817``, ``def_hermiteLift:834-863``) as closed-form,
index-table-driven jittable functions.  The MATLAB code builds symbolic
expressions and compiles them with ``matlabFunction``; here each family is a
static exponent/multiplier table (host numpy) plus a pure function
``zeta -> features`` that XLA can fuse and batch.

Basis layout invariants (must match the reference for golden-data parity):
- the first ``nzeta_aug`` entries of the full basis are zeta itself
  (``Ksysid.m:484``),
- family features follow in ``obs_type`` order,
- a constant 1 ends the basis (``Ksysid.m:505``),
- loaded composition:    [g ; w1*g ; ... ; w_nw*g]      (``Ksysid.m:595-599``)
- bilinear composition:  [g ; u1*g ; ... ; um*g]        (``Ksysid.m:508-516``)
- monomial exponent rows follow the recursive ordering of ``partitions.m``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from koopman_realizations.config import SysidConfig

__all__ = [
    "partitions_ones",
    "poly_exponents",
    "poly_parent_tables",
    "KoopmanBasis",
    "build_basis",
]


def partitions_ones(total: int, n: int) -> np.ndarray:
    """All non-negative integer vectors of length ``n`` summing to ``total``.

    Row order replicates ``partitions.m:206-219`` with
    ``candidate_set = ones(1, n)``: recurse over the count of the *last*
    element (0..total), so e.g. ``partitions_ones(1, 3)`` is the identity
    [[1,0,0],[0,1,0],[0,0,1]].  This ordering is what fixes the reference's
    monomial order, so golden matrices stay comparable.
    """
    if n == 1:
        return np.array([[total]], dtype=np.int32)
    rows = []
    for i in range(total + 1):
        sub = partitions_ones(total - i, n - 1)
        rows.append(np.concatenate([sub, np.full((sub.shape[0], 1), i, np.int32)], axis=1))
    return np.concatenate(rows, axis=0)


def poly_exponents(nzeta: int, degree: int) -> np.ndarray:
    """Exponent rows for all monomials of total degree 1..degree.

    Mirrors ``Ksysid.def_polyLift:644-648``.  Row count is
    C(nzeta+degree, degree) - 1 (constant excluded); the first ``nzeta`` rows
    are the identity (degree-1 monomials = zeta itself).
    """
    return np.concatenate([partitions_ones(d, nzeta) for d in range(1, degree + 1)], axis=0)


def _count_poly(nzeta: int, degree: int) -> int:
    return math.comb(nzeta + degree, degree) - 1


def poly_parent_tables(nz: int, degree: int):
    """Parent-recurrence gather tables for the degree-blocked poly lift.

    Every degree-d monomial is z_i times a unique degree-(d-1) parent
    (lowest nonzero exponent dimension); evaluating block d is then ONE
    static gather + ONE elementwise multiply.  Returns a list over degrees
    2..degree of (parent_idx, dim_idx) int32 arrays indexing into the
    previous block / into z, plus the exponent blocks themselves
    (``partitions.m`` row order, so feature layout is reference-exact).
    """
    blocks = [partitions_ones(d, nz) for d in range(1, degree + 1)]
    tables = []
    pos = {tuple(int(v) for v in e): r for r, e in enumerate(blocks[0])}
    for d in range(2, degree + 1):
        parent_idx = np.empty(len(blocks[d - 1]), np.int32)
        dim_idx = np.empty(len(blocks[d - 1]), np.int32)
        newpos = {}
        for r, row in enumerate(blocks[d - 1]):
            e = tuple(int(v) for v in row)
            i = next(k for k in range(nz) if e[k] > 0)
            parent = e[:i] + (e[i] - 1,) + e[i + 1:]
            parent_idx[r] = pos[parent]
            dim_idx[r] = i
            newpos[e] = r
        tables.append((parent_idx, dim_idx))
        pos = newpos
    return blocks, tables


def _hermite_table(max_order: int, z):
    """Physicists' Hermite polynomials H_0..H_max evaluated elementwise.

    H_0 = 1, H_1 = 2z, H_{k+1} = 2 z H_k - 2 k H_{k-1}  (hermiteH semantics,
    used by ``Ksysid.get_hermite:820-831``).
    Returns array of shape (max_order+1,) + z.shape.
    """
    rows = [jnp.ones_like(z)]
    if max_order >= 1:
        rows.append(2.0 * z)
    for k in range(1, max_order):
        rows.append(2.0 * z * rows[k] - 2.0 * k * rows[k - 1])
    return jnp.stack(rows, axis=0)


@dataclasses.dataclass(frozen=True, eq=False)
class KoopmanBasis:
    """A fully-specified observable dictionary.

    ``eq=False``: a basis rides model pytrees as STATIC aux data
    (``models.koopman._model_pytree``), where jit cache keys hash and
    compare it -- the auto-generated field-wise __eq__/__hash__ raise on
    the numpy tables (pcs, centers).  Identity semantics are correct
    there: a rebuilt-but-equal basis just retraces.

    Host-side container: exponent tables are numpy constants baked into the
    jitted lifting functions (never traced).  ``lift`` and friends operate on
    single vectors; batch with ``jax.vmap``.

    Attributes
    ----------
    n, m, nd : state/input dims and delay count
    nzeta    : n*(nd+1) + m*nd            (``Ksysid.m:86``)
    nzeta_aug: nzeta (+ m for 'nonlinear' models, whose lift consumes
               [zeta; u] -- ``Ksysid.m:475-477``)
    N        : dimension of the (econ) basis == reference ``params.N``
    N_full   : dimension of the full (pre-PCA) basis
    pcs      : optional (N_full, npcs) PCA components defining the econ basis
               [zeta_aug ; pcs^T g(zeta_aug) ; 1]  (``Ksysid.m:1614-1618``)
    """

    model_type: str
    n: int
    m: int
    nd: int
    nw: int
    families: Tuple[Tuple[str, int], ...]
    gaussian_centers: Optional[np.ndarray] = None  # (nzeta_aug, degree)
    pcs: Optional[np.ndarray] = None

    # ---- dimensions -------------------------------------------------------

    @property
    def nzeta(self) -> int:
        return self.n * (self.nd + 1) + self.m * self.nd

    @property
    def nzeta_aug(self) -> int:
        return self.nzeta + (self.m if self.model_type == "nonlinear" else 0)

    def _family_count(self, kind: str, degree: int) -> int:
        nz = self.nzeta_aug
        if kind == "poly":
            return _count_poly(nz, degree) - nz  # first nz rows are repeats
        if kind == "fourier":
            return (1 + 2 * degree) ** nz - 1
        if kind == "fourier_sparser":
            return _count_poly(2 * nz, degree)
        if kind == "gaussian":
            return degree
        if kind == "hermite":
            return _count_poly(nz, degree)
        raise ValueError(f"unknown observable family {kind!r}")

    @property
    def N_full(self) -> int:
        """Full basis length: zeta + families + trailing constant."""
        return (
            self.nzeta_aug
            + sum(self._family_count(k, d) for k, d in self.families)
            + 1
        )

    @property
    def N(self) -> int:
        """Dimension of the working (econ) basis (reference ``params.N``)."""
        if self.pcs is None:
            return self.N_full
        return self.nzeta_aug + self.pcs.shape[1] + 1

    @property
    def N_loaded(self) -> int:
        return self.N * (self.nw + 1)

    # ---- family evaluation ------------------------------------------------

    def _family_feats(self, kind: str, degree: int, zeta):
        nz = self.nzeta_aug
        if kind == "poly":
            # Parent-recurrence evaluation, vectorized per degree: every
            # degree-d monomial is z_i times a degree-(d-1) monomial, so
            # each degree block is ONE static gather + ONE elementwise
            # multiply (v_d = v_{d-1}[parent] * z[dim]).  The exponent-table
            # gather this replaces ((rows, nz) advanced indexing into the
            # power table) materializes a (B, rows, nz) intermediate under
            # vmap and dominated the lift cost; a scalar-by-scalar
            # recurrence (one multiply per row + a rows-way stack) provokes
            # an XLA:CPU compiler segfault at this width.  Row order is untouched (``partitions.m`` order).
            _, tables = poly_parent_tables(nz, degree)
            feats, prev = [], zeta
            for parent_idx, dim_idx in tables:
                prev = prev[parent_idx] * zeta[dim_idx]
                feats.append(prev)
            if not feats:                    # degree 1: no extra monomials
                return jnp.zeros((0,), zeta.dtype)
            return jnp.concatenate(feats)
        if kind == "fourier":
            # per-dim [1, cos(2*pi*j*z), sin(2*pi*j*z)]_j, full tensor kron
            # (Ksysid.def_fourierLift:707-724); kron runs last dim fastest.
            cols = []
            for i in range(nz):
                entries = [jnp.ones(())]
                for j in range(1, degree + 1):
                    entries.append(jnp.cos(2 * jnp.pi * j * zeta[i]))
                    entries.append(jnp.sin(2 * jnp.pi * j * zeta[i]))
                cols.append(jnp.stack(entries))
            feats = cols[0]
            for i in range(1, nz):
                feats = (feats[:, None] * cols[i][None, :]).reshape(-1)
            return feats[1:]  # drop leading constant
        if kind == "fourier_sparser":
            # products of sin/cos with partition-limited multipliers
            # (Ksysid.def_fourierLift_sparser:746-760, get_sinusoid:770-787)
            M = np.concatenate(
                [partitions_ones(d, 2 * nz) for d in range(1, degree + 1)], axis=0
            )
            Ms, Mc = M[:, :nz], M[:, nz:]
            zs = zeta[None, :]
            sin_part = jnp.where(Ms > 0, jnp.sin(2 * jnp.pi * Ms * zs), 1.0)
            cos_part = jnp.where(Mc > 0, jnp.cos(2 * jnp.pi * Mc * zs), 1.0)
            return jnp.prod(sin_part, axis=1) * jnp.prod(cos_part, axis=1)
        if kind == "gaussian":
            # RBFs with random centers in [-1,1] (Ksysid.def_gaussianLift:801-810)
            z0 = self.gaussian_centers  # (nz, degree)
            r2 = jnp.sum((zeta[:, None] - z0) ** 2, axis=0)
            return jnp.exp(-r2)
        if kind == "hermite":
            O = np.concatenate(
                [partitions_ones(d, nz) for d in range(1, degree + 1)], axis=0
            )
            H = _hermite_table(degree, zeta)  # (degree+1, nz)
            return jnp.prod(H[O, np.arange(nz)[None, :]], axis=1)
        raise ValueError(f"unknown observable family {kind!r}")

    # ---- lifting functions ------------------------------------------------

    def lift_full(self, zeta_aug):
        """Full basis g(zeta_aug) of length N_full (``Ksysid.m:484-533``)."""
        zeta_aug = jnp.asarray(zeta_aug)
        if zeta_aug.shape != (self.nzeta_aug,):
            raise ValueError(
                f"lift expects zeta of shape ({self.nzeta_aug},), got {zeta_aug.shape}"
            )
        parts = [zeta_aug]
        for kind, degree in self.families:
            parts.append(self._family_feats(kind, degree, zeta_aug))
        parts.append(jnp.ones((1,), zeta_aug.dtype))
        return jnp.concatenate(parts)

    def lift(self, zeta_aug):
        """Working (econ) basis of length N (``Ksysid.econ_full:1614-1618``)."""
        if self.pcs is None:
            return self.lift_full(zeta_aug)
        zeta_aug = jnp.asarray(zeta_aug)
        g = self.lift_full(zeta_aug)
        gecon = jnp.asarray(self.pcs.T, g.dtype) @ g
        return jnp.concatenate([zeta_aug, gecon, jnp.ones((1,), g.dtype)])

    def lift_loaded(self, zeta_aug, w):
        """[g ; w1*g ; ...] of length N*(nw+1) (``Ksysid.m:595-599``)."""
        g = self.lift(zeta_aug)
        one_w = jnp.concatenate([jnp.ones((1,), g.dtype), jnp.asarray(w, g.dtype)])
        return (one_w[:, None] * g[None, :]).reshape(-1)

    def lift_input(self, zeta_aug, u):
        """[g ; u1*g ; ...] bilinear lift, length N*(m+1) (``Ksysid.m:508-516``)."""
        g = self.lift(zeta_aug)
        one_u = jnp.concatenate([jnp.ones((1,), g.dtype), jnp.asarray(u, g.dtype)])
        return (one_u[:, None] * g[None, :]).reshape(-1)

    def lift_loaded_input(self, zeta_aug, w, u):
        """Bilinear + loaded lift, length N*(nw+1)*(m+1) (``Ksysid.m:601-610``)."""
        gl = self.lift_loaded(zeta_aug, w)
        one_u = jnp.concatenate([jnp.ones((1,), gl.dtype), jnp.asarray(u, gl.dtype)])
        return (one_u[:, None] * gl[None, :]).reshape(-1)

    def with_pcs(self, pcs: np.ndarray) -> "KoopmanBasis":
        return dataclasses.replace(self, pcs=np.asarray(pcs))


def build_basis(cfg: SysidConfig, n: int, m: int, nw: int = 0,
                rng: Optional[np.random.Generator] = None) -> KoopmanBasis:
    """Construct the observable dictionary for a sysid configuration.

    Gaussian centers are drawn uniformly from [-1,1] (``Ksysid.m:803``) using
    a seeded numpy Generator for reproducibility (the reference uses the
    global MATLAB RNG and is not reproducible).
    """
    families = tuple(zip(cfg.obs_type, cfg.obs_degree))
    basis = KoopmanBasis(
        model_type=cfg.model_type, n=n, m=m, nd=cfg.delays,
        nw=nw if cfg.loaded else 0, families=families,
    )
    if any(k == "gaussian" for k, _ in families):
        rng = rng or np.random.default_rng(cfg.seed)
        deg = max(d for k, d in families if k == "gaussian")
        centers = 2.0 * rng.random((basis.nzeta_aug, deg)) - 1.0
        basis = dataclasses.replace(basis, gaussian_centers=centers)
    return basis


# ---- delay embedding -------------------------------------------------------

def delay_embed(y: np.ndarray, u: np.ndarray, nd: int):
    """Build zeta_k = [y_k, y_{k-1..k-nd}, u_{k-1..k-nd}] rows.

    Mirrors ``Ksysid.get_zeta:868-907``.  Returns (zeta [T-nd, nzeta],
    uzeta [T-nd, m]) where row i corresponds to original time index i+nd.
    Host-side numpy; in-loop controllers keep a rolling window instead.
    """
    y = np.asarray(y)
    u = np.asarray(u)
    T = y.shape[0]
    if nd == 0:
        return y.copy(), u.copy()
    rows = []
    for i in range(nd, T):
        ydel = [y[i - j] for j in range(1, nd + 1)]
        udel = [u[i - j] for j in range(1, nd + 1)]
        rows.append(np.concatenate([y[i]] + ydel + udel))
    return np.stack(rows), u[nd:].copy()


def zeta_from_window(ywin, uwin, nd: int):
    """zeta for the most recent step from trailing windows (jit-friendly).

    ywin: [nd+1, n] rows oldest..newest; uwin: [nd+1, m].  Matches the layout
    ``Kmpc.get_mpcInput`` builds via ``get_zeta`` (newest measurement first,
    then y-delays, then u-delays).
    """
    ywin = jnp.asarray(ywin)
    uwin = jnp.asarray(uwin)
    parts = [ywin[-1]]
    for j in range(1, nd + 1):
        parts.append(ywin[-1 - j])
    for j in range(1, nd + 1):
        parts.append(uwin[-1 - j])
    return jnp.concatenate(parts)
