"""Full-float32 matrix products for the geometry.

At its DEFAULT precision XLA may run a float32 matmul or einsum on the
GPU's tensor cores in TF32, which keeps a 10-bit mantissa (~1e-3
relative).  The geometry here multiplies pixel coordinates of ~2000 and
scene coordinates of kilometres, and builds one-hot selections out of
products, so that rounding moves decisions: on an H100 the localize
search's err1 changed by up to 15x on 10 of 458 candidates (different
inlier sets) and 3 of 4096 ray-cast hits moved by more than 1 m, against
the CPU backend; at HIGHEST the largest differences were 4.2e-4 relative
and 3.4e-5 m (chip run, PR 1).  Every product in ``ops``, ``models``,
``ba``, ``parallel``, the device code of ``pipelines`` and the one-hot
patch fetch of ``features.match`` goes through these two helpers (or
passes ``HIGHEST`` to ``lax.dot_general``); no global flag is set.  The perception products of ``features`` (banded
Harris convolutions, descriptor similarity) keep the default precision.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST

#: ``a @ b`` at full float32 precision.
mm = partial(jnp.matmul, precision=HIGHEST)
#: ``jnp.einsum`` at full float32 precision.
einsum = partial(jnp.einsum, precision=HIGHEST)
