"""Persistent host-setup cache (counterpart of
``pgdrome_tpu/utils/setup_cache.py``): assembled and preconditioned
operator stacks, pickled to disk.

Building and preconditioning a high-d problem in host f64 takes seconds;
its products are numpy arrays that load at disk speed.  The cache is off
unless ``$PGDROME_SETUP_CACHE`` names a directory (or the caller passes
``cache_dir``).

The key hashes the caller's parameters and the source of the passed
functions (their own source only, not their callees': pass every function
whose edits should invalidate a snapshot, or change ``key_data``).  The
port's keys never equal the JAX package's: a shared cache directory would
otherwise hand the port a pickle of ``pgdrome_tpu`` classes, and loading
it would import JAX.  Values are picklable objects — the port's
:class:`~pgdrome_tpu_torch.separated.SeparatedProblem` and
:class:`~pgdrome_tpu_torch.separated.Dim0Transform` of host arrays.
"""

from __future__ import annotations

import hashlib
import inspect
import logging
import os
import pickle
import tempfile
import time

LOGGER = logging.getLogger(__name__)

_ENV_DIR = "PGDROME_SETUP_CACHE"
_VERSION = "torch-setup-v1"  # the JAX package's is "setup-v1"


def default_cache_dir():
    """Cache dir from $PGDROME_SETUP_CACHE, or None (caching disabled)."""
    return os.environ.get(_ENV_DIR) or None


def _key(key_data, code_objects):
    h = hashlib.sha256()
    h.update(_VERSION.encode())
    for item in key_data:
        h.update(repr(item).encode())
    for fn in code_objects:
        try:
            h.update(inspect.getsource(fn).encode())
        except (OSError, TypeError):  # builtins / C funcs: name only
            h.update(getattr(fn, "__qualname__", repr(fn)).encode())
    return h.hexdigest()[:32]


def cached_setup(build_fn, key_data, code_objects=(), cache_dir=None):
    """``build_fn()`` with a persistent on-disk result cache.

    Returns ``(value, status)`` with status 'hit', 'miss' or 'off'.
    ``key_data``: reprable items that determine the value (builder
    parameters, shapes, dtypes).  ``code_objects``: functions whose source
    joins the key.  ``cache_dir=None`` defers to ``$PGDROME_SETUP_CACHE``
    (unset: caching off, just build).  A file that fails to load is
    rebuilt; a value that fails to store is returned all the same."""
    cache_dir = cache_dir or default_cache_dir()
    if cache_dir is None:
        return build_fn(), "off"

    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, _key(key_data, code_objects) + ".setup")
    if os.path.exists(path):
        try:
            t0 = time.perf_counter()
            with open(path, "rb") as f:
                value = pickle.load(f)
            LOGGER.info(
                "setup cache hit: %s (%.1f MB; read %.2fs)", path,
                os.path.getsize(path) / 1e6, time.perf_counter() - t0,
            )
            return value, "hit"
        except Exception as e:  # corrupt or stale format: rebuild
            LOGGER.warning("setup cache load failed (%s); rebuilding", e)
            try:
                os.unlink(path)
            except OSError:
                pass

    value = build_fn()
    tmp = None
    try:
        # atomic publish: a concurrent reader never sees a short file
        fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            pickle.dump(value, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
        tmp = None
        LOGGER.info(
            "setup cache store: %s (%.1f MB)", path,
            os.path.getsize(path) / 1e6,
        )
    except Exception as e:  # unpicklable value or full disk: keep going
        LOGGER.warning("setup cache store failed (%s); caching disabled", e)
    finally:
        if tmp is not None:  # a failed store leaves no partial .tmp
            try:
                os.unlink(tmp)
            except OSError:
                pass
    return value, "miss"
