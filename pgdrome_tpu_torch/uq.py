"""Exact variance-based (Sobol'/ANOVA) sensitivity analysis of separated
PGD solutions (counterpart of ``pgdrome_tpu/uq.py``: host numpy in f64,
with the factor mass matrices from :mod:`pgdrome_tpu_torch.fem.assembly`).

With independent parameters p_j and a separated vademecum

    u(x, p) = sum_k F0_k(x) * prod_j Fj_k(p_j)

every ANOVA term reduces to products of per-dim 1D moments of the FE
factor interpolants,

    m_j[k]   = E_{p_j}[ Fj_k ],      G_j[k,l] = E_{p_j}[ Fj_k Fj_l ],

both EXACT through the factor mass matrix (FE quadrature integrates the
piecewise-polynomial products exactly: ``\\int f g rho = f^T M_rho g``).
Mean, total variance, first-order/second-order/total/group Sobol'
indices then follow from O(d^2 * rank^2) host-f64 contractions — no
sampling, no FOM solves, no tensor grid.

Closed-form global sensitivity is a payoff of the separated
representation itself; this module is the serving-side realization (see
``Vademecum.sobol``).  The MCMC diagnostics of
``Vademecum.sample_posterior`` (split R-hat, effective sample size) live
here too.

Formulas (independent parameters; standard Sobol'/Hoeffding ANOVA).
For any subset S of parameter dims, the CLOSED variance

    V_S^c = Var( E[u | p_S] )
          = sum_kl a_k a_l ( prod_{j in S} G_j ∘ prod_{i not in S} m_i m_i^T )_kl
            - E[u]^2

gives everything:

    first order   S_j   = V_{j}^c / Var
    second order  S_ij  = ( V_{ij}^c - V_i^c - V_j^c ) / Var
    total effect  ST_j  = 1 - V_{~j}^c / Var
    group closed / total analogously for |S| > 1

with a_k the dim-0 output weights (mode values at sensor points, or a
Gram for aggregated field indices — see ``sobol_from_stats``).
Generalized (field-aggregated) indices follow Lamboni/Gamboa: numerator
and denominator variances are integrated against the dim-0 mass measure
before the ratio.
"""

from __future__ import annotations

import numpy as np


def factor_stats(spaces, modes, n_modes, densities=None):
    """Exact per-parameter-dim factor moments ``[(m (R,), G (R, R)), …]``.

    spaces/modes: the PARAMETER dims only (each a 1D scalar
    FunctionSpace + (>=R, n_j) mode buffer).  densities: optional list
    (len == number of parameter dims) of UNNORMALIZED densities — each
    None (uniform) or a scalar / callable / fem Function accepted as an
    assembly ``weight``; normalization happens here.  All math f64."""
    from pgdrome_tpu_torch.fem.assembly import mass_matrix

    if densities is None:
        densities = [None] * len(spaces)
    if len(densities) != len(spaces):
        raise ValueError(
            f"densities must have one entry per parameter dim "
            f"({len(spaces)}), got {len(densities)}"
        )
    stats = []
    for V, mbuf, rho in zip(spaces, modes, densities):
        if V.value_size != 1 or V.mesh().topology_dim() != 1:
            raise ValueError(
                "parameter dims must be 1D scalar spaces "
                f"(got value_size={V.value_size}, "
                f"tdim={V.mesh().topology_dim()})"
            )
        M = np.asarray(mass_matrix(V, weight=rho), np.float64)
        ones = np.ones(M.shape[0])
        vol = float(ones @ M @ ones)
        if not (np.isfinite(vol) and vol > 0.0):
            raise ValueError(
                f"density must have positive mass (got integral {vol})"
            )
        F = np.asarray(mbuf, np.float64)[: int(n_modes)]
        MF = F @ M  # (R, n_j)
        stats.append((MF @ ones / vol, MF @ F.T / vol))
    return stats


def _mixed_product(stats, g_dims):
    """(R, R) elementwise product with G_j for dims in ``g_dims`` and
    m_j m_j^T otherwise — the kernel of every closed ANOVA variance.
    O(d·R²) flops, O(R²) memory (no prefix stacks: the R² temporaries,
    not the flops, are the slow resource on this host)."""
    g_dims = set(g_dims)
    out = None
    for j, (m, G) in enumerate(stats):
        if out is None:
            out = (G if j in g_dims else np.outer(m, m)).copy()
        elif j in g_dims:
            np.multiply(out, G, out=out)
        else:
            # rank-1 factor without materializing the outer product
            out *= m[:, None]
            out *= m[None, :]
    return out


def sobol_from_stats(stats, table=None, out_gram=None, second_order=False):
    """ANOVA/Sobol' contractions from per-dim factor stats.

    stats: ``factor_stats`` output.  Exactly one of:

    * ``table (R, n_out)`` — dim-0 output weights per mode (e.g. mode
      values at sensor points): PER-OUTPUT indices, arrays ``(…, n_out)``;
    * ``out_gram (R, R)`` — Gram of the dim-0 modes under the output
      measure (``U W U^T``): AGGREGATED (generalized) indices, scalars.

    Returns dict with ``mean`` (table path only), ``variance``,
    ``first (d, …)``, ``total (d, …)``, and with ``second_order=True``
    also ``second (d, d, …)`` — the pairwise INTERACTION indices S_ij
    (i < j filled, symmetric, zero diagonal; O(d²) extra R² products).
    Indices are NOT clipped: values outside [0, 1] at roundoff scale are
    honest numerical noise, large violations indicate a broken input."""
    if (table is None) == (out_gram is None):
        raise ValueError("pass exactly one of table / out_gram")
    d = len(stats)
    P = np.ones_like(stats[0][0])
    for m, _ in stats:
        P = P * m

    if table is not None:
        t = np.asarray(table, np.float64)

        def quad(X):
            return np.einsum("ko,ko->o", X @ t, t)

        mean = P @ t
        mean2 = mean * mean
    else:
        B = np.asarray(out_gram, np.float64)

        def quad(X):
            return float(np.einsum("kl,kl->", X, B))

        mean = None
        mean2 = float(P @ B @ P)

    e2 = quad(_mixed_product(stats, range(d)))
    var = e2 - mean2
    closed = [quad(_mixed_product(stats, [j])) - mean2 for j in range(d)]
    total = [e2 - quad(_mixed_product(stats, [i for i in range(d) if i != j]))
             for j in range(d)]
    # guard the all-deterministic edge (variance ~ 0): indices undefined
    eps = np.finfo(np.float64).tiny
    denom = np.where(np.abs(var) < eps, np.inf, var)
    out = {
        "variance": var,
        "first": np.asarray(closed) / denom,
        "total": np.asarray(total) / denom,
    }
    if second_order:
        shape = (d, d) + np.shape(var)
        S2 = np.zeros(shape)
        for i in range(d):
            for j in range(i + 1, d):
                vij = quad(_mixed_product(stats, [i, j])) - mean2
                S2[i, j] = S2[j, i] = (vij - closed[i] - closed[j]) / denom
        out["second"] = S2
    if mean is not None:
        out["mean"] = mean
    return out


def output_covariance(stats, table):
    """Exact mean vector and covariance MATRIX of the outputs under the
    parameter measure:

        mean_a     = E[u(x_a)]
        Cov[a, b]  = E[u(x_a) u(x_b)] - mean_a mean_b
                   = sum_kl t_ka t_lb ( prod_j G_j - prod_j m_j m_j^T )_kl

    closed-form through the same per-dim factor moments as the Sobol'
    machinery (``factor_stats``) — no sampling.  table: (R, n_out) dim-0
    output weights per mode (mode values at sensor points).  Returns
    ``(mean (n_out,), cov (n_out, n_out))``; cov's diagonal equals the
    per-output ANOVA ``variance`` of ``sobol_from_stats``, and it is
    the exact covariance that Monte-Carlo ``Vademecum.moments`` only
    estimates.  O(R^2 (d + n_out)) host f64.

    Uses: observation-noise-free data covariance for assimilation /
    Kalman updates, correlation between QoIs, low-rank surrogate
    screening of sensor redundancy (complements D-optimal design,
    which targets PARAMETER information instead)."""
    t = np.asarray(table, np.float64)
    if t.ndim != 2 or t.shape[0] != stats[0][0].shape[0]:
        raise ValueError(
            f"table must be (R={stats[0][0].shape[0]}, n_out), "
            f"got {t.shape}"
        )
    P = np.ones_like(stats[0][0])
    for m, _ in stats:
        P = P * m
    mean = P @ t
    K = _mixed_product(stats, range(len(stats)))  # (R, R): prod_j G_j
    cov = t.T @ K @ t - np.outer(mean, mean)
    # exact symmetry is structural; enforce it against roundoff
    return mean, 0.5 * (cov + cov.T)


def main_effect(stats, j, factor_values, table):
    """Closed-form ANOVA main-effect curve of parameter ``j``:

        g_j(v) = E[u | p_j = v] - E[u]
               = sum_k a_k ( Fj_k(v) - m_j[k] ) * prod_{i≠j} m_i[k]

    factor_values: (R, n_v) factor-j interpolant values at the curve
    abscissae (``evaluate_modes_1d``), table: (R, n_out) dim-0 output
    weights.  Returns ``(mean (n_out,), effect (n_v, n_out))`` — the
    conditional-mean DEVIATION curves whose per-dim variances are the
    first-order Sobol' numerators.  O(R·(n_v+n_out)): plotting-cheap."""
    d = len(stats)
    if not 0 <= int(j) < d:
        raise ValueError(f"j must be in 0..{d - 1}")
    t = np.asarray(table, np.float64)
    F = np.asarray(factor_values, np.float64)
    P = np.ones_like(stats[0][0])
    for m, _ in stats:
        P = P * m
    mean = P @ t
    rest = np.ones_like(P)
    for i, (m, _) in enumerate(stats):
        if i != int(j):
            rest = rest * m
    centered = F - stats[int(j)][0][:, None]  # (R, n_v)
    effect = (centered * rest[:, None]).T @ t  # (n_v, n_out)
    return mean, effect


def split_rhat(chains):
    """Split-chain Gelman–Rubin R̂ per dimension.

    chains: (L, C, d) — L post-burn samples from C chains.  Each chain
    is split in half (2C sequences of length L//2), R̂² = (within-seq
    variance blended with between-seq variance) / within.  R̂ ≈ 1 at
    convergence; > 1.01–1.05 means the chains have not mixed.  Returns
    (d,) f64; a dimension with zero within-chain variance (all chains
    stuck) returns inf unless the between-variance is zero too (a
    genuinely deterministic dim → 1.0)."""
    x = np.asarray(chains, np.float64)
    if x.ndim != 3 or x.shape[0] < 4:
        raise ValueError(f"chains must be (L>=4, C, d), got {x.shape}")
    half = x.shape[0] // 2
    x = np.concatenate([x[:half], x[half : 2 * half]], axis=1)
    n = half
    means = x.mean(axis=0)                      # (2C, d)
    W = x.var(axis=0, ddof=1).mean(axis=0)      # (d,)
    B = n * means.var(axis=0, ddof=1)           # (d,)
    var_plus = (n - 1) / n * W + B / n
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.sqrt(var_plus / W)
    return np.where(W > 0, r, np.where(B > 0, np.inf, 1.0))


def effective_sample_size(chains):
    """Effective sample size per dimension (Stan-style: split chains,
    chain-averaged autocovariance against the blended variance,
    Geyer initial-positive-sequence truncation).

    chains: (L, C, d) post-burn samples.  Returns (d,) f64 — ≈ L·C for
    independent draws, much smaller for sticky chains; the Monte-Carlo
    s.e. of a posterior mean is std/√ESS."""
    x = np.asarray(chains, np.float64)
    if x.ndim != 3 or x.shape[0] < 4:
        raise ValueError(f"chains must be (L>=4, C, d), got {x.shape}")
    half = x.shape[0] // 2
    x = np.concatenate([x[:half], x[half : 2 * half]], axis=1)
    n, m, d = x.shape
    xc = x - x.mean(axis=0, keepdims=True)
    # per-chain autocovariance via FFT, biased (1/n) normalization
    nfft = 1 << int(np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, n=nfft, axis=0)
    acov = np.fft.irfft(f * np.conj(f), n=nfft, axis=0)[:n].real / n
    acov_m = acov.mean(axis=1)                  # (n, d) chain-averaged
    W = x.var(axis=0, ddof=1).mean(axis=0)
    B = n * x.mean(axis=0).var(axis=0, ddof=1)
    var_plus = (n - 1) / n * W + B / n
    ess = np.empty(d)
    for j in range(d):
        if var_plus[j] <= 0:
            ess[j] = n * m  # deterministic dim: no MC error at all
            continue
        rho = 1.0 - (W[j] - acov_m[:, j]) / var_plus[j]
        # Geyer: sum lag pairs (2t, 2t+1) while the pair sum is positive
        s, t = 0.0, 1
        while t + 1 < n:
            pair = rho[t] + rho[t + 1]
            if pair < 0:
                break
            s += pair
            t += 2
        ess[j] = n * m / max(1.0, 1.0 + 2.0 * s)
    return ess


def sobol_group(stats, group, table=None, out_gram=None):
    """Closed and total Sobol' indices of a GROUP of parameter dims.

    group: iterable of parameter-dim indices (0-based into ``stats``).
    Returns dict ``{'closed', 'total', 'variance'}`` — closed =
    Var(E[u|p_group])/Var (all effects involving ONLY group members),
    total = 1 − Var(E[u|p_rest])/Var (all effects involving AT LEAST
    one member).  Shapes follow ``sobol_from_stats``' table/out_gram
    convention.  Useful when parameters form physical blocks (e.g. the
    d=10 frontier's material vs. load parameters)."""
    if (table is None) == (out_gram is None):
        raise ValueError("pass exactly one of table / out_gram")
    d = len(stats)
    group = sorted(set(int(g) for g in group))
    if not group or group[0] < 0 or group[-1] >= d:
        raise ValueError(f"group must be non-empty subset of 0..{d - 1}")
    P = np.ones_like(stats[0][0])
    for m, _ in stats:
        P = P * m
    if table is not None:
        t = np.asarray(table, np.float64)

        def quad(X):
            return np.einsum("ko,ko->o", X @ t, t)

        mean2 = (P @ t) ** 2
    else:
        B = np.asarray(out_gram, np.float64)

        def quad(X):
            return float(np.einsum("kl,kl->", X, B))

        mean2 = float(P @ B @ P)
    e2 = quad(_mixed_product(stats, range(d)))
    var = e2 - mean2
    rest = [i for i in range(d) if i not in group]
    eps = np.finfo(np.float64).tiny
    denom = np.where(np.abs(var) < eps, np.inf, var)
    closed = (quad(_mixed_product(stats, group)) - mean2) / denom
    # empty rest: E[u|p_rest] = E[u] ⇒ V_rest = 0 ⇒ total = var/var
    v_rest = (quad(_mixed_product(stats, rest)) - mean2) if rest else 0.0
    total = (var - v_rest) / denom
    return {"variance": var, "closed": closed, "total": total}
