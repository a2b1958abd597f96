"""Transcript tracing — the execution-tracker analogue (SURVEY.md §5).

The reference's `simfony debug` prints every jet call with decoded values
(the reference's simfony-cli/src/tracker.rs:43-63).  This framework's
equivalent is a transcript dump: record every Fiat-Shamir channel
operation (mix/draw) with its resulting digest while running the verifier
eagerly, for bit-exactness triage against the native oracle
(`native/symphony verify-stwo -v` prints the same digests).

Usage:
    with record_transcript() as events:
        verifier.verify(proof, cfg)      # run OUTSIDE jit
    print(format_transcript(events))
"""

from __future__ import annotations

import contextlib
from typing import Any, List, Tuple

import jax
import numpy as np

_TRACE: List[Tuple[str, Any]] | None = None


def emit(op: str, value) -> None:
    """Record one channel event if tracing is active.  `value` must be a
    concrete (non-traced) array — callers run under `jax.disable_jit()`."""
    if _TRACE is not None:
        _TRACE.append((op, np.asarray(value)))


@contextlib.contextmanager
def record_transcript():
    """Context manager: collects (op, value) channel events; disables jit
    so values are concrete (tracing a jitted verify would record tracers)."""
    global _TRACE
    prev = _TRACE
    _TRACE = []
    try:
        with jax.disable_jit():
            yield _TRACE
    finally:
        _TRACE = prev


def _hex_words(words: np.ndarray) -> str:
    flat = np.atleast_1d(words).reshape(-1)
    return "".join(f"{int(w):08x}" for w in flat)


def format_transcript(events) -> str:
    lines = []
    for i, (op, value) in enumerate(events):
        lines.append(f"[{i:3d}] {op:<14s} {_hex_words(value)}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Op-level tracing — the full jet-tracker analogue
# ---------------------------------------------------------------------------
#
# The reference's `simfony debug` decodes EVERY jet call with typed
# arguments and results (/root/reference/simfony-cli/src/tracker.rs:43-63).
# `record_ops()` is the equivalent depth: it temporarily wraps the field /
# hash / Merkle primitives so each call records (op_name, decoded args,
# decoded result) while the verifier runs eagerly.  Zero overhead when not
# tracing: the originals are restored on exit and the hot path carries no
# hooks.

# (module, attribute) pairs wrapped by record_ops — the "jets" of this
# framework.  Mirrors the jet families the reference tracker decodes.
# Modules that import a hash function by name (``from ...ops.sha256 import
# sha256_words``) are patched too: rebinding only ops.sha256's global would
# miss their call sites.
_OP_SITES = [
    ("stark_symphony.ops.field",
     ("m31_add", "m31_sub", "m31_mul", "m31_neg", "m31_inv",
      "cm31_mul", "cm31_inv",
      "qm31_mul", "qm31_inv", "qm31_mul_m31", "qm31_mul_cm31")),
    ("stark_symphony.ops.sha256", ("sha256_words", "sha256_pair")),
    ("stark_symphony.ops.merkle",
     ("compute_root", "sha256_pair")),
    ("stark_symphony.ops.circle",
     ("point_add", "point_from_index")),
    ("stark_symphony.ops.field101",
     ("f_add", "f_sub", "f_mul", "f_inv", "f_pow", "mod_u64")),
    # direct-import call sites of the hash ops
    ("stark_symphony.models.stwo.verifier",
     ("sha256_words", "sha256_pair")),
    ("stark_symphony.models.stwo.channel", ("sha256_words",)),
    ("stark_symphony.models.stark101.verifier", ("sha256_words",)),
    ("stark_symphony.models.stark101.channel", ("sha256_words",)),
]


def _summarize(x):
    """Decode one argument/result into a compact printable form."""
    try:
        a = np.asarray(x)
    except Exception:
        return repr(x)
    if a.ndim == 0:
        return f"{int(a):#x}" if np.issubdtype(a.dtype, np.integer) else str(a)
    flat = a.reshape(-1)
    if flat.size <= 8 and np.issubdtype(a.dtype, np.integer):
        return "[" + " ".join(f"{int(v):08x}" for v in flat) + "]"
    return f"<{a.dtype}{list(a.shape)}>"


@contextlib.contextmanager
def record_ops(ops=None):
    """Record every primitive-op call with decoded args and results.

    Usage:
        with record_ops() as events:
            verifier.verify(proof, cfg)        # runs eagerly (jit disabled)
        print(format_ops(events))

    `ops`: optional iterable of op names to restrict to (e.g. {"m31_mul"}).
    Events are (name, [decoded args], decoded result) tuples.  Like
    `record_transcript`, runs under `jax.disable_jit()` so values are
    concrete.
    """
    import importlib

    events: List[tuple] = []
    saved = []
    only = set(ops) if ops is not None else None

    def _wrap(name, fn):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            if only is None or name in only:
                events.append(
                    (name, [_summarize(a) for a in args], _summarize(out))
                )
            return out

        wrapper.__name__ = f"traced_{name}"
        wrapper.__wrapped__ = fn
        return wrapper

    for mod_name, attrs in _OP_SITES:
        mod = importlib.import_module(mod_name)
        for attr in attrs:
            if not hasattr(mod, attr):
                continue
            orig = getattr(mod, attr)
            saved.append((mod, attr, orig))
            setattr(mod, attr, _wrap(attr, orig))
    try:
        with jax.disable_jit():
            yield events
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)


def format_ops(events, limit: int | None = None) -> str:
    lines = []
    for i, (name, args, out) in enumerate(events):
        if limit is not None and i >= limit:
            lines.append(f"... ({len(events) - limit} more)")
            break
        lines.append(f"[{i:5d}] {name:<16s} ({', '.join(args)}) -> {out}")
    return "\n".join(lines)
