"""Disk cache for own-prover proofs, keyed by the prover sources' hash.

Proving is jit-compiled; its XLA compile costs minutes of (slow) CPU the
first time.  Benchmarks and driver entry points measure *verification*,
so the proof itself is cached under tests/.proof_cache and regenerated
automatically whenever any source the proof depends on changes.
"""

from __future__ import annotations

import hashlib
import pathlib

_PKG = pathlib.Path(__file__).parent.parent
_ROOT = _PKG.parent
_CACHE = _ROOT / "tests" / ".proof_cache"

_STWO_SOURCES = tuple(
    sorted(str(p) for p in (_PKG / "ops").glob("*.py"))
) + tuple(
    str(_PKG / "models" / "stwo" / f)
    for f in ("prover.py", "proof.py", "channel.py", "config.py",
              "constraints.py")
)


_STALE_SERVED: list = []


def stwo_source_hash() -> str:
    h = hashlib.sha256()
    for p in _STWO_SOURCES:
        h.update(pathlib.Path(p).read_bytes())
    return h.hexdigest()[:16]


def _cfg_hash(cfg) -> str:
    """Short hash over EVERY config field, so no two distinct configs can
    share a cache entry (advisor r03: keying on hand-picked fields let
    configs differing only in e.g. pow_bits collide)."""
    import dataclasses

    return hashlib.sha256(
        repr(sorted(dataclasses.asdict(cfg).items())).encode()
    ).hexdigest()[:12]


def cached_stwo_proof(cfg, tag: str = "", air: str = "wide_fibonacci",
                      seed=None):
    """One stwo proof from the in-tree prover for `cfg`, disk-cached.

    `tag` is cosmetic only (the key is the full config + source hash), so
    callers using different tags for the same config share one entry.
    `seed` (optional int) keys distinct-trace proofs for mixed batches.
    """
    import os
    import re
    import sys
    import tempfile

    import jax
    import numpy as np

    from ..models.stwo import proof as P
    from ..models.stwo import prover

    _CACHE.mkdir(parents=True, exist_ok=True)
    seed_part = "" if seed is None else f"_s{int(seed)}"
    prefix = f"stwo_{air}_{_cfg_hash(cfg)}{seed_part}_"
    src = stwo_source_hash()
    path = _CACHE / f"{prefix}{src}.npz"

    def _same_trace(p: pathlib.Path) -> bool:
        # A seed=None glob on `prefix` would also match seeded entries
        # ('..._s3_<srchash>'): the remainder after the prefix must be the
        # source hash (hex — never starts with 's'), not a seed marker.
        rest = p.name[len(prefix):]
        return seed is not None or not re.match(r"s\d+_", rest)

    strict = os.environ.get("STPU_PROOFCACHE_STRICT", "0") == "1"
    candidates = [path] if path.exists() else []
    if not candidates and not strict:
        # stale-source fallback: a source edit rarely changes proof BYTES;
        # every downstream consumer asserts the proof verifies, so a truly
        # stale proof is caught there — while non-semantic edits skip the
        # minutes-long prover re-run.  Delete tests/.proof_cache or set
        # STPU_PROOFCACHE_STRICT=1 to force regeneration instead.
        candidates = sorted(
            (p for p in _CACHE.glob(f"{prefix}*.npz") if _same_trace(p)),
            key=lambda p: p.stat().st_mtime, reverse=True,
        )
    if not candidates:
        # committed fixtures (cold machines: skip the prover compile);
        # exact source-hash match first, stale fixtures only if not strict
        fixdir = _ROOT / "tests" / "fixtures" / "own_proofs"
        exact = fixdir / f"{prefix}{src}.npz"
        if exact.exists():
            candidates = [exact]
        elif not strict:
            candidates = sorted(
                p for p in fixdir.glob(f"{prefix}*.npz") if _same_trace(p)
            )
    for cand in candidates:
        try:
            loaded = P.load_npz(str(cand))
        except Exception:
            # truncated cache write: drop and regenerate.  NEVER unlink a
            # committed fixture (it is a tracked repo file) — skip it.
            if _CACHE in cand.parents:
                cand.unlink(missing_ok=True)
            else:
                print(f"[proofcache] unreadable fixture skipped: {cand}",
                      file=sys.stderr)
            continue
        if not cand.name.endswith(f"{src}.npz") and not _STALE_SERVED:
            _STALE_SERVED.append(cand.name)  # say it once per process
            print(
                f"[proofcache] serving stale-source proof {cand.name} "
                f"(current source hash {src}; set STPU_PROOFCACHE_STRICT=1 "
                "to force regeneration)", file=sys.stderr)
        return loaded
    kwargs = {}
    if seed is not None:
        t = 1 << cfg.trace_log_size
        row = np.arange(1, t + 1, dtype=np.uint64)
        seeds = (row * np.uint64(2 * int(seed) + 1)) % np.uint64(
            (1 << 31) - 1
        ) + 1
        kwargs["trace"] = prover.generate_trace(cfg, seeds=seeds, air=air)
    proof, _ = prover.prove(cfg, air=air, **kwargs)
    proof = jax.tree_util.tree_map(lambda x: np.asarray(x), proof)
    # atomic publish: concurrent writers (multi-host shared FS) each write
    # a private temp file; os.replace is atomic on POSIX
    # suffix must be .npz or np.savez appends one and os.replace misses it
    fd, tmp = tempfile.mkstemp(dir=str(_CACHE), suffix=".tmp.npz")
    os.close(fd)
    try:
        P.save_npz(tmp, proof)
        os.replace(tmp, str(path))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return proof
