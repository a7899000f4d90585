"""Bayesian posterior sampling over a served vademecum (counterpart of
``pgdrome_tpu/parallel/bayes.py``, single device).

The forward model of a calibration problem — parameters → sensor
responses — is the vademecum's sensor sweep, so a random-walk Metropolis
step of C chains costs one (C, n_modes) × (n_modes, n_out) product: the
chains ride the batch axis and advance together.  The observation, the
noise level and the proposal's shape and scale are call inputs, so the
step-size adaptation of ``Vademecum.sample_posterior`` and new datasets
reuse one built sampler.

Randomness is explicit: the draws come from a ``torch.Generator`` on the
sampler's device, or are passed in whole (``eps``, ``e``), which is how a
test feeds the sampler exactly the normals and exponentials of another
implementation.  The steps run eagerly, ~40 launches each.
"""

from __future__ import annotations

import torch

from pgdrome_tpu_torch.config import use_full_f32_matmul
from pgdrome_tpu_torch.parallel.vademecum import (
    _factors,
    _like,
    _mode_mask,
    _table_tensor,
    param_box,
    parse_prior,
)

use_full_f32_matmul()


def make_mcmc_fn(spaces, modes, n_modes, points, table=None, n_steps=500,
                 prior=None):
    """Build the batched random-walk Metropolis sampler::

        mcmc(obs (n_out,), sigma (n_out,), p0 (C, d_p), chol (d_p, d_p),
             scale, generator=None, eps=None, e=None)
            → (chain (n_steps, C, d_p), n_accept (C,))

    Log-posterior: −½‖(sensor(p) − obs)/σ‖² [− ½‖Γ(p − p_prior)‖²], with a
    uniform prior on the box of the factor meshes always enforced by
    rejection (clipping proposals would bias the chain; outside the box
    the interpolants extrapolate).  ``prior=(p_prior, gamma)`` adds an
    independent Gaussian with γ_j = 1/σ_prior,j — the convention of
    :func:`~pgdrome_tpu_torch.parallel.vademecum.make_fit_fn`, whose
    regularised cost is −2·log posterior, so that fit's optimum is this
    density's mode.

    Step t proposes p + scale·(eps[t] @ cholᵀ) and accepts iff
    Δlog p > −e[t] (exact Metropolis in log space: e ~ Exp(1)).  ``eps``
    (n_steps, C, d_p) standard normals and ``e`` (n_steps, C) standard
    exponentials are drawn from ``generator`` (on the modes' device) when
    not given.  ``chain[t]`` is the state after step t; ``chain[-1]`` fed
    back as ``p0`` continues the chains.  Computes in the modes' dtype on
    their device; the inputs are cast there."""
    modes0 = modes[0]
    dt, dev = modes0.dtype, modes0.device
    d_p = len(spaces) - 1
    n_steps = int(n_steps)
    table = _table_tensor(spaces, modes0, points, table)
    mask = _mode_mask(modes0, n_modes)
    if prior is not None:
        pp, g2 = _like(parse_prior(prior, d_p), modes0)
    lo, hi = _like(param_box(spaces), modes0)

    def logpost(p, obs, inv_sigma):
        r = (_factors(spaces, modes, p, mask) @ table - obs[None, :]) * inv_sigma[None, :]
        lp = -0.5 * (r * r).sum(-1)
        if prior is not None:
            lp = lp - 0.5 * (g2[None, :] * (p - pp[None, :]) ** 2).sum(-1)
        inside = ((p >= lo[None, :]) & (p <= hi[None, :])).all(-1)
        return torch.where(inside, lp, torch.full_like(lp, -float("inf")))

    def mcmc(obs, sigma, p0, chol, scale, generator=None, eps=None, e=None):
        def put(a):
            return torch.as_tensor(a, dtype=dt, device=dev)

        obs, p = put(obs).reshape(-1), put(p0)
        inv_sigma = 1.0 / put(sigma).reshape(-1)
        chol, scale = put(chol), put(scale)
        C = p.shape[0]
        if eps is None:
            eps = torch.randn((n_steps, C, d_p), generator=generator, device=dev, dtype=dt)
        if e is None:
            e = torch.empty((n_steps, C), device=dev, dtype=dt).exponential_(
                generator=generator)
        eps, e = put(eps), put(e)
        if eps.shape != (n_steps, C, d_p) or e.shape != (n_steps, C):
            raise ValueError(f"eps must be ({n_steps}, {C}, {d_p}) and e "
                             f"({n_steps}, {C})")
        lp = logpost(p, obs, inv_sigma)
        n_acc = torch.zeros((C,), dtype=torch.int32, device=dev)
        chain = torch.empty((n_steps, C, d_p), dtype=dt, device=dev)
        for t in range(n_steps):
            prop = p + scale * (eps[t] @ chol.T)
            lp_prop = logpost(prop, obs, inv_sigma)
            acc = (lp_prop - lp) > -e[t]
            p = torch.where(acc[:, None], prop, p)
            lp = torch.where(acc, lp_prop, lp)
            n_acc += acc.to(torch.int32)
            chain[t] = p
        return chain, n_acc

    return mcmc
