"""The kernel build cache of a restarted pod: the counterpart of the JAX
package's ``utils/compilation_cache.py``.

There, a pod that restarts (eviction, resume: the cases
``workload/loop.py`` exists for) reads its compiled step from a volume
instead of compiling it again. Here, what a restart would compile again is
the ``nvcc`` build of the hand-written kernels (``ops/_build.py``), so the
cache is that build's directory: ``$TPU_WORKLOAD_COMPILATION_CACHE_DIR``
(mount a hostPath or PVC there in the pod spec) when it is set, else
``ops/build/`` beside the sources. Each library is named by a hash of its
sources and flags, so a warm directory is read and an edited source is
built anew into it.
"""

from __future__ import annotations

import os
from pathlib import Path

from ..ops import _build

ENV_VAR = _build.CACHE_DIR_ENV


def maybe_enable(cache_dir: str | os.PathLike | None = None) -> bool:
    """Build the kernels into ``cache_dir`` (the argument wins over
    ``$TPU_WORKLOAD_COMPILATION_CACHE_DIR``) when one is configured. Safe
    to call repeatedly; returns whether the cache is on.

    The directory is created if missing and must be writable: one that
    cannot be used raises, and the build never falls back to another
    directory. The choice is put in this process's environment, so the
    rank processes a launcher starts build into, and read from, the same
    directory."""
    d = cache_dir or os.environ.get(ENV_VAR, "")
    if not d:
        return False
    path = _build.usable_dir(Path(d).absolute())
    os.environ[ENV_VAR] = str(path)
    return True
