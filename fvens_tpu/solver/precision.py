"""Matrix products at full float32 precision.

On the GPU, XLA may run a float32 `dot_general` in TF32, which keeps about
three decimal digits, unless the operation asks for more. The Krylov
solver, the block preconditioners and the line solves were validated at
full f32 (the mixed-precision implicit step and its regression gates), so
every product on the implicit step's path goes through these wrappers,
which pin `precision=HIGHEST` per operation. f64 products are unaffected.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST

einsum = partial(jnp.einsum, precision=HIGHEST)
matmul = partial(jnp.matmul, precision=HIGHEST)
dot = partial(jnp.dot, precision=HIGHEST)
vdot = partial(jnp.vdot, precision=HIGHEST)
