"""symphony debug — transcript dumper CLI (the `simfony debug` analogue,
/root/reference/simfony-cli/src/main.rs:211-248 + tracker.rs:43-80).

Runs a verifier eagerly with channel tracing enabled and prints every
Fiat-Shamir mix/draw with its digest, plus the per-stage validity masks.
Cross-check oracle: `native/symphony verify-stwo <proof.json> -v` prints
the same digests.

Usage:
    python -m stark_symphony.tools.debug stwo <proof.json>
    python -m stark_symphony.tools.debug stark101 <proof.json>
"""

from __future__ import annotations

import argparse
import os
import sys

# transcript triage is host-side work: eager per-op dispatch to an
# accelerator would be pathologically slow, so default to the CPU backend.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np

from ..utils.trace import (
    format_ops,
    format_transcript,
    record_ops,
    record_transcript,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="symphony-debug")
    ap.add_argument("scheme", choices=["stwo", "stark101"])
    ap.add_argument("proof_json")
    ap.add_argument(
        "--ops", action="store_true",
        help="decode EVERY primitive op call (field/hash/Merkle/circle) "
        "with typed args and results — the full jet-tracker depth of the "
        "reference's `simfony debug` (tracker.rs:43-63); default traces "
        "channel mix/draw events only",
    )
    ap.add_argument(
        "--ops-filter", default=None,
        help="comma-separated op names to restrict --ops to (e.g. "
        "'m31_mul,sha256_pair')",
    )
    ap.add_argument(
        "--limit", type=int, default=None,
        help="print at most N op events",
    )
    args = ap.parse_args(argv)

    only = set(args.ops_filter.split(",")) if args.ops_filter else None
    recorder = (
        record_ops(only) if args.ops else record_transcript()
    )

    if args.scheme == "stwo":
        from ..models.stwo import proof as P
        from ..models.stwo import verifier

        proof, cfg = P.load_json(args.proof_json)
        with recorder as events:
            ok, masks = verifier.verify(proof, cfg)
    else:
        from ..models.stark101 import proof as P
        from ..models.stark101 import verifier
        from ..models.stark101.config import Stark101Config

        proof = P.load_json(args.proof_json)
        cfg = Stark101Config()
        with recorder as events:
            ok, masks = verifier.verify(proof, cfg)

    if args.ops:
        print(format_ops(events, limit=args.limit))
    else:
        print(format_transcript(events))
    print("--- masks ---")
    for name, m in masks.items():
        print(f"{'ok  ' if bool(np.asarray(m).all()) else 'FAIL'} {name}")
    accepted = bool(np.asarray(ok).all())
    print(f"result: {'ACCEPT' if accepted else 'REJECT'}")
    return 0 if accepted else 1


if __name__ == "__main__":
    sys.exit(main())
