"""Weights across: trained states of the JAX package into the port.

The JAX package saves a trained decomposition with ``np.savez`` as the
arrays ``m0 … m{d−1}`` (padded mode buffers, (n_max, n_d) each),
``n_modes``, ``amplitudes``, ``alpha``, ``fp_its`` and ``normU0``
(``pgdrome_tpu/recipes.py:693-700``).  For the parametric-elliptic
frontier states the dim-0 modes live in the energy basis of
``precondition_dim0``, so serving them needs the same host build.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from pgdrome_tpu_torch.separated import PGDResult


def result_from_numpy(modes, n_modes, amplitudes, alpha, fp_its, normU0=1.0):
    """The port's :class:`PGDResult` from a JAX ``PGDResult``'s arrays as
    numpy: modes become host float64 tensors (the serving container casts
    and moves them), the traces stay numpy."""
    return PGDResult(
        modes=[torch.as_tensor(np.asarray(m, dtype=np.float64)) for m in modes],
        n_modes=int(n_modes),
        amplitudes=np.asarray(amplitudes),
        alpha=np.asarray(alpha),
        fp_its=np.asarray(fp_its),
        normU0=float(normU0),
    )


def load_state_npz(path) -> PGDResult:
    """Read a saved state (``m0``, ``m1``, …, ``n_modes``, ``amplitudes``,
    ``alpha``, ``fp_its``, ``normU0``) into a :class:`PGDResult`."""
    with np.load(Path(path)) as z:
        nd = 0
        while f"m{nd}" in z.files:
            nd += 1
        if nd < 2:
            raise ValueError(f"{path}: no mode arrays m0, m1, … found")
        return result_from_numpy(
            [z[f"m{d}"] for d in range(nd)], z["n_modes"], z["amplitudes"],
            z["alpha"], z["fp_its"], z["normU0"],
        )


def frontier_spaces(num_params, n_x=1024, n_p=128):
    """The spaces and the dim-0 transform of a parametric-elliptic frontier
    state: ``parametric_elliptic(n_x, n_p, num_params, degree_x=2)`` built
    and preconditioned on the host in f64.  Returns ``(spaces, tf)``."""
    from pgdrome_tpu_torch.models.problems import parametric_elliptic
    from pgdrome_tpu_torch.separated import precondition_dim0

    sep, spaces = parametric_elliptic(n_x=n_x, n_p=n_p, num_params=num_params,
                                      degree_x=2)
    _, tf = precondition_dim0(sep, np.float64)
    return spaces, tf


def frontier_vademecum(path, num_params, n_x=1024, n_p=128, device="cuda",
                       dtype=torch.float32, method="auto"):
    """A ready :class:`~pgdrome_tpu_torch.serving.Vademecum` for a saved
    parametric-elliptic frontier state (``states/frontier_d5_state.npz`` or
    the ANOVA-started ``states/frontier_anova_d5_state.npz`` with
    ``num_params=5``, ``states/frontier_anova_d10_state.npz`` with
    ``num_params=10``): host build, dim-0 transform, modes mapped to full
    dofs and put on ``device``."""
    from pgdrome_tpu_torch.config import get_device
    from pgdrome_tpu_torch.serving import Vademecum

    device = get_device(device)  # raise before the host build, not after
    spaces, tf = frontier_spaces(num_params, n_x=n_x, n_p=n_p)
    result = load_state_npz(path)
    return Vademecum(spaces, result, dim0_transform=tf, method=method,
                     dtype=dtype, device=device)
