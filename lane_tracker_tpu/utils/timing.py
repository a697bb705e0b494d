"""Per-iteration device time of a jittable function.

A host timing of single calls includes the host's dispatch, the launch
and the fetch of the result, which at small per-call times can dominate
what the device did.  This protocol removes them:

  1. Chain N iterations of the function *inside one jitted program* with a
     real data dependency between iterations (lax.fori_loop), so the device
     must execute all N sequentially.
  2. Fetch one scalar derived from the final result (forces completion and
     transfer).
  3. Subtract the fixed cost of a call (same protocol with N=0).

per-iteration time = (T(N) - T(0)) / N.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np


def device_time_per_iter(make_carry, body, n_iters=50, repeats=3,
                         invariant=None):
    """Median per-iteration device time of ``body``.

    Args:
        make_carry: () -> carry pytree (device inputs).
        body: carry [, invariant] -> carry, the computation to time. Must
            have a data dependency from input carry to output carry.
        n_iters: chained iterations inside the jitted program.
        repeats: timing repetitions (median taken).
        invariant: optional pytree passed to ``body`` as a second argument
            but NOT loop-carried — use for large read-only inputs (weights)
            that would otherwise be double-buffered by the loop (and must
            not be closed over: closures become compile-time constants).

    Returns:
        (seconds_per_iter, fixed_call_seconds)
    """

    def chained(carry, inv, n):
        def step(_, c):
            return body(c) if invariant is None else body(c, inv)

        return jax.lax.fori_loop(0, n, step, carry)

    def probe(carry):
        leaves = jax.tree_util.tree_leaves(carry)
        return sum(jnp.sum(l.astype(jnp.float32)) for l in leaves)

    f_n = jax.jit(lambda c, inv: probe(chained(c, inv, n_iters)))
    f_0 = jax.jit(lambda c, inv: probe(c))

    carry = make_carry()
    float(f_n(carry, invariant))
    float(f_0(carry, invariant))

    def timed(f):
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            float(f(carry, invariant))
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    t_n = timed(f_n)
    t_0 = timed(f_0)
    return max(t_n - t_0, 0.0) / n_iters, t_0
