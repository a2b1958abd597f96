"""Overflow-safety asserts + determinism notes (SURVEY.md §5 sanitizers).

The reference runs on a deterministic VM with typed jets; this build's
equivalent discipline is:

* Determinism: all kernels are pure uint32 integer programs — XLA compiles
  them to bit-deterministic code on every backend (no floating-point
  reductions, no atomics, no cross-replica nondeterminism).  Cross-run
  bit-exactness is additionally pinned by the golden-vector test suite.

* Overflow safety: the field kernels assume *canonical* inputs (M31 in
  [0, p), F_q in [0, q)) and rely on intermediate values fitting the lane
  width; a violated precondition silently wraps.  With ``STPU_CHECK=1``
  the primitives assert their preconditions via `jax.debug.callback`
  (works under jit; host-evaluated) — the analogue of running the
  reference under its type-checked BitMachine instead of bare jets.
  NOTE: the raised ``FloatingPointError`` is only catchable as that type
  in eager mode; under jit the callback's exception surfaces as an XLA
  runtime error (possibly deferred by async dispatch until the next
  ``block_until_ready``).  Callers needing a typed, synchronously
  catchable failure under jit should use ``jax.experimental.checkify``.

Zero overhead when disabled: the checks are trace-time no-ops.
"""

from __future__ import annotations

import os


def enabled() -> bool:
    return os.environ.get("STPU_CHECK", "0") == "1"


def _host_assert(ok, msg: str) -> None:
    import numpy as np

    if not bool(np.asarray(ok)):
        raise FloatingPointError(msg)  # distinct, catchable type


def check_lt(x, bound: int, what: str) -> None:
    """Assert all lanes of `x` < bound (debug mode only)."""
    if not enabled():
        return
    import jax
    import jax.numpy as jnp

    x = jnp.asarray(x)
    nbits = x.dtype.itemsize * 8
    if int(bound) >= (1 << nbits):
        # every representable lane value satisfies the bound — casting the
        # bound down to x's dtype would silently wrap and pass bad inputs
        return
    ok = jnp.all(x < x.dtype.type(bound))
    jax.debug.callback(
        lambda o, m=f"overflow check failed: {what} (bound {bound:#x})":
        _host_assert(o, m),
        ok,
    )
