"""Weights across: trained states of the JAX package into the port.

The JAX package saves a trained decomposition with ``np.savez`` as the
arrays ``m0 … m{d−1}`` (padded mode buffers, (n_max, n_d) each),
``n_modes``, ``amplitudes``, ``alpha``, ``fp_its`` and ``normU0``
(``pgdrome_tpu/recipes.py:693-700``).  For the parametric-elliptic
frontier states the dim-0 modes live in the energy basis of
``precondition_dim0``, so serving them needs the same host build.

Its deployed snapshots (``Vademecum.save``, ``Certifier.save``) are HDF5
files; the port writes the same keys to ``.npz`` and reads both
(:func:`read_snapshot`).  ``h5py`` is imported only to read an HDF5 file.
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


_H5_SUFFIXES = (".h5", ".hdf5")


def read_h5_snapshot(path) -> dict:
    """The JAX package's HDF5 snapshot (``Vademecum.save`` or
    ``Certifier.save``) as a dict under the keys of the port's ``.npz``:
    every file attribute and dataset by name, and the ``degree`` attribute
    of a dataset ``<name>_{d}`` as ``degree_{d}``.  Needs ``h5py``,
    imported here; without it this raises ``ImportError``."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"{path}: reading an HDF5 snapshot needs h5py, which is not "
            "installed; save it again as .npz with the port, or install h5py"
        ) from e
    out = {}
    with h5py.File(Path(path), "r") as f:
        for k, v in f.attrs.items():
            out[k] = np.asarray(v)
        for name, ds in f.items():
            out[name] = np.asarray(ds)
            if "degree" in ds.attrs:
                out["degree_" + name.rsplit("_", 1)[1]] = np.asarray(ds.attrs["degree"])
    return out


def read_snapshot(path, spaces, kind="vademecum") -> dict:
    """A deployed snapshot as a dict of host arrays — the port's ``.npz``,
    or the JAX package's HDF5 file by its suffix (``.h5`` / ``.hdf5``,
    :func:`read_h5_snapshot`) — validated against ``spaces``: one space per
    saved dim, and each dim's mesh vertices (``coords_{d}``) and degree
    (``degree_{d}``), which a ``kind="vademecum"`` snapshot always holds and
    a ``"certifier"`` one where it was saved with its spaces."""
    path = Path(path)
    if path.suffix.lower() in _H5_SUFFIXES:
        z = read_h5_snapshot(path)
    else:
        with np.load(path) as f:
            z = {k: f[k] for k in f.files}
    nd = int(z["num_dims"])
    if len(spaces) != nd:
        raise ValueError(f"expected {nd} spaces, got {len(spaces)}")
    for d in range(nd):
        if kind != "vademecum" and f"coords_{d}" not in z:
            continue
        saved = np.asarray(z[f"coords_{d}"])
        have = spaces[d].mesh().coordinates()
        if saved.shape != have.shape or not np.allclose(saved, have):
            raise ValueError(f"space {d} mesh does not match the saved {kind}")
        if int(z[f"degree_{d}"]) != spaces[d].degree:
            raise ValueError(f"space {d} degree mismatch")
    return z


def frontier_build(num_params, n_x=1024, n_p=128):
    """The spaces and the dim-0 transform of a parametric-elliptic frontier
    state: ``parametric_elliptic(n_x, n_p, num_params, degree_x=2)`` built
    and preconditioned on the host in f64.  Returns ``(spaces, tf)``."""
    from pgdrome_tpu_torch.models.problems import parametric_elliptic
    from pgdrome_tpu_torch.separated import precondition_dim0

    sep, spaces = parametric_elliptic(n_x=n_x, n_p=n_p, num_params=num_params,
                                      degree_x=2)
    _, tf = precondition_dim0(sep, np.float64)
    return spaces, tf


def load_dual_states(paths, sep, Vx, sensors):
    """The committed adjoint states of the goal-oriented frontier
    (``states/frontier_dual_d10_s{0,1}.npz``, one per sensor, as
    :func:`~pgdrome_tpu_torch.recipes.goal_oriented_frontier` checkpoints
    them) with what serving them needs: per sensor x0 of ``sensors``,
    ``(res_z, tf_z, l)`` — the state, the dim-0 transform of its adjoint
    problem (``adjoint_problem(sep, l)`` preconditioned on the host in
    f64, as the recipe solved it) and the point functional l over ``Vx``.
    ``sep``: the host-f64 un-boosted primal problem of the build."""
    from pgdrome_tpu_torch.dual import adjoint_problem, point_functional
    from pgdrome_tpu_torch.separated import precondition_dim0

    if len(paths) != len(sensors):
        raise ValueError(f"{len(paths)} dual states for {len(sensors)} sensors")
    out = []
    for path, x0 in zip(paths, sensors):
        l = point_functional(Vx, x0)
        _, tf_z = precondition_dim0(adjoint_problem(sep, l), np.float64)
        res_z = load_state_npz(path)
        if res_z.modes[0].shape[1] != len(tf_z.interior):
            raise ValueError(f"{path}: dim-0 modes of {res_z.modes[0].shape[1]} dofs do not "
                             f"fit the adjoint build's {len(tf_z.interior)}")
        out.append((res_z, tf_z, l))
    return out


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
    spaces, tf = frontier_build(num_params, n_x=n_x, n_p=n_p)
    result = load_state_npz(path)
    return Vademecum(spaces, result, dim0_transform=tf, method=method,
                     dtype=dtype, device=device)
