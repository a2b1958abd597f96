"""AOT build of the batched verifier — the `simfony build` analogue.

The reference compiles a verifier once and emits a reusable program
artifact with a static cost report (simfony-cli/src/main.rs:121-161:
program/witness sizes + node.bounds()).  The analogue here:

* ``build``: jit-lower + compile ``verify_batch_tiled`` (or the standard
  path) for a fixed (config, batch) and serialize the compiled PJRT
  executable to disk (jax.experimental.serialize_executable).  A fresh
  process then loads and runs it in seconds instead of minutes of XLA
  compilation.
* a static cost report: SHA-256 compressions per proof per stage — the
  ``node.bounds()`` analogue for a hash-dominated verifier.

Artifacts are device-specific (PJRT executables), like any AOT object
file; the filename records backend + config + batch.

SECURITY: artifacts are pickled PJRT state — loading one executes
arbitrary code, exactly like loading any native object file.  Load only
artifacts you built yourself.  A SHA-256 frame (magic + digest prefix)
guards against corruption/truncation, not against a malicious author.

Usage:
    python -m stark_symphony.tools.build [--config production|testing]
        [--batch 2048] [--path standard|tiled] [--out build/]
    python -m stark_symphony.tools.build --load <artifact> [--check]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pickle
import sys
import time

_MAGIC = b"STPUAOT1"

os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), ".jax_cache"),
)


def static_cost(cfg) -> dict:
    """SHA-256 compressions per proof, per stage (the node.bounds()
    analogue; message framing per ops/sha256._padding_words)."""
    q = cfg.n_queries
    d = cfg.lde_log_size
    n_layers = 1 + cfg.n_inner_layers
    # transcript: ~3 root mixes + 12 qm31 draws (2 attempts) + oods mix
    # (88 words -> 6 blocks) + last mix + pow + 2 query draws
    transcript = 3 + 2 * (3 + n_layers) + 6 + 1 + 1 + (q + 7) // 8
    # stage V: leaf hash (trace: C words -> 1 block; cp: 16+pad -> 2) +
    # walk (2 compr per level)
    stage_v = q * (1 + 2 * d) + q * (2 + 2 * d)
    # stage VII per layer: 2 leaf hashes + node pair (2) + walk depth_l
    stage_vii = sum(
        q * (2 + 2 + 2 * cfg.fri_layer_depth(l)) for l in range(n_layers)
    )
    total = transcript + stage_v + stage_vii
    return {
        "transcript_compr": transcript,
        "stage_v_compr": stage_v,
        "stage_vii_compr": stage_vii,
        "total_compr_per_proof": total,
    }


def verifier_source_hash() -> str:
    """Hash of every source the compiled verifier executable depends on;
    a mismatch means an AOT artifact is stale and must be rebuilt."""
    import hashlib as _h
    import pathlib

    pkg = pathlib.Path(__file__).parent.parent
    files = sorted(
        [str(p) for p in (pkg / "ops").glob("*.py")]
        + [str(p) for p in (pkg / "ops" / "pallas").glob("*.py")]
        + [str(pkg / "models" / "stwo" / f)
           for f in ("verifier.py", "tiled.py", "channel.py", "config.py",
                     "constraints.py", "proof.py")]
    )
    h = _h.sha256()
    for p in files:
        h.update(pathlib.Path(p).read_bytes())
    return h.hexdigest()[:16]


def make_chained(cfg, chain: int, tiled_path: bool):
    """The chained-verification loop bench.py times: `chain` verifications
    inside one fori_loop, each data-dependent on the previous bitmap via a
    compiler-opaque runtime zero (see bench.py docstring)."""
    import jax
    import jax.numpy as jnp

    from ..models.stwo import verifier

    def chained(b, seed_bits):
        def body(i, carry):
            zero = carry[0] ^ jnp.uint32(1)
            b2 = b._replace(commitments=b.commitments ^ zero)
            if tiled_path:
                bm = verifier.verify_batch_tiled(b2, cfg,
                                                 linkage="reference")
            else:
                bm = verifier.verify_batch(b2, cfg, linkage="reference")
            return bm.astype(jnp.uint32)

        return jax.lax.fori_loop(0, chain, body, seed_bits)

    return chained


def artifact_name(cfg_name: str, path: str, batch: int, backend: str,
                  chain: int = 0) -> str:
    part = f"_c{chain}" if chain else ""
    return f"verify_{cfg_name}_{path}_b{batch}{part}_{backend}.aot"


def build(cfg_name: str, batch: int, path: str, out_dir: str,
          chain: int = 0) -> str:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_compilation_cache_dir",
                      os.environ["JAX_COMPILATION_CACHE_DIR"])
    from jax.experimental import serialize_executable as se

    from ..models.stwo import proof as P
    from ..models.stwo import tiled, verifier
    from ..models.stwo.config import PRODUCTION, TESTING
    from ..utils.proofcache import cached_stwo_proof

    cfg = PRODUCTION if cfg_name == "production" else TESTING
    proof = cached_stwo_proof(cfg)
    b = P.replicate(proof, batch)
    if path == "tiled":
        arg = tiled.tile_batch(b, cfg)
        fn = jax.jit(
            lambda x: verifier.verify_batch_tiled(x, cfg, linkage="reference")
        )
    else:
        arg = b
        fn = jax.jit(
            lambda x: verifier.verify_batch(x, cfg, linkage="reference")
        )
    if chain:
        fn = jax.jit(make_chained(cfg, chain, path == "tiled"))
        args = (arg, jnp.ones((batch,), jnp.uint32))
    else:
        args = (arg,)

    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    blob, in_tree, out_tree = se.serialize(compiled)

    backend = jax.default_backend()
    os.makedirs(out_dir, exist_ok=True)
    name = artifact_name(cfg_name, path, batch, backend, chain)
    out_path = os.path.join(out_dir, name)
    payload = pickle.dumps({
        "blob": blob,
        "in_tree": in_tree,
        "out_tree": out_tree,
        "config": cfg_name,
        "batch": batch,
        "path": path,
        "backend": backend,
        "chain": chain,
        "source_hash": verifier_source_hash(),
    })
    with open(out_path, "wb") as f:
        f.write(_MAGIC + hashlib.sha256(payload).digest() + payload)

    report = {
        "artifact": out_path,
        "bytes": os.path.getsize(out_path),
        "compile_s": round(compile_s, 1),
        "backend": backend,
        "batch": batch,
        **static_cost(cfg),
    }
    print(json.dumps(report))
    return out_path


def load(artifact: str):
    """Load an AOT artifact; returns (callable, meta dict).

    TRUSTED INPUT ONLY: the payload is a pickle (see module docstring).
    The integrity frame is verified before unpickling, so corrupted or
    truncated artifacts fail cleanly instead of executing garbage.
    """
    import jax

    from jax.experimental import serialize_executable as se

    with open(artifact, "rb") as f:
        raw = f.read()
    if not raw.startswith(_MAGIC):
        raise ValueError(
            f"{artifact}: not a stark-symphony AOT artifact (bad magic); "
            "rebuild with tools.build")
    digest, payload = raw[len(_MAGIC):len(_MAGIC) + 32], \
        raw[len(_MAGIC) + 32:]
    if hashlib.sha256(payload).digest() != digest:
        raise ValueError(f"{artifact}: integrity check failed (corrupted "
                         "or tampered artifact); rebuild with tools.build")
    data = pickle.loads(payload)
    t0 = time.perf_counter()
    fn = se.deserialize_and_load(data["blob"], data["in_tree"],
                                 data["out_tree"])
    data["load_s"] = round(time.perf_counter() - t0, 2)
    # stale = the verifier sources changed since this executable was built
    data["stale"] = data.get("source_hash") != verifier_source_hash()
    return fn, data


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="production",
                    choices=["production", "testing"])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--path", default="tiled",
                    choices=["tiled", "standard"])
    ap.add_argument("--out", default="build")
    ap.add_argument("--chain", type=int, default=0,
                    help="also wrap `chain` verifications in one fori_loop "
                         "(the executable bench.py times)")
    ap.add_argument("--load", default=None,
                    help="load an artifact instead of building")
    ap.add_argument("--check", action="store_true",
                    help="after load, run one batch and assert acceptance")
    args = ap.parse_args(argv)

    if args.load:
        fn, meta = load(args.load)
        print(json.dumps({"loaded": args.load, "load_s": meta["load_s"],
                          "backend": meta["backend"],
                          "stale": meta["stale"]}))
        if args.check:
            import jax.numpy as jnp
            import numpy as np

            from ..models.stwo import proof as P
            from ..models.stwo import tiled
            from ..models.stwo.config import PRODUCTION, TESTING
            from ..utils.proofcache import cached_stwo_proof

            cfg = PRODUCTION if meta["config"] == "production" else TESTING
            b = P.replicate(cached_stwo_proof(cfg), meta["batch"])
            arg = tiled.tile_batch(b, cfg) if meta["path"] == "tiled" else b
            fargs = (arg,) if not meta.get("chain") else (
                arg, jnp.ones((meta["batch"],), jnp.uint32))
            t0 = time.perf_counter()
            bitmap = np.asarray(fn(*fargs))
            dt = time.perf_counter() - t0
            assert bitmap.all(), "AOT-loaded verifier rejected valid proofs"
            print(json.dumps({"check": "ok", "batch": meta["batch"],
                              "first_run_s": round(dt, 3)}))
        return 0

    build(args.config, args.batch, args.path, args.out, args.chain)
    return 0


if __name__ == "__main__":
    sys.exit(main())
