"""Device-layout (tiled) stwo proof batches for the stage-kernel fast path.

The stage kernels (ops/pallas/gpu_stages.py) read each u32 word of a
per-query array as one vector over the flattened (batch, query) lane axis,
while the proof container stores words as the trailing axis.  This module
performs that relayout ONCE, on the host, at proof-ingestion time (the
analogue of the reference's witness generation step,
stwo-verifier/scripts/generate_wit.py — layout preparation is part of
ingesting a proof, not of verifying it):

* ``tile_batch(proof_batch, cfg)`` -> ``StwoTiledBatch`` with every
  per-query array laid out as ``(..., words, M, 128)`` (lane = b * Q + q,
  padded to a whole kernel lane block), small per-proof arrays left as-is
  for the transcript stages.
* ``verifier.verify_batch_tiled`` consumes it.

The lane order b*Q + q makes every (B, Q) <-> lane conversion a free
reshape, so only word-axis transposes happen here.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import sys
from typing import NamedTuple

import numpy as np

from ...ops.pallas.gpu_stages import LANE_BLOCK
from .config import StwoConfig
from .proof import StwoProof

LANES = 128  # minor axis of the (..., W, M, 128) container

# Native relayout (native/tile.cpp): the word-major transpose is the host
# ingestion cost of the tiled path; the blocked pthread transpose beats
# single-threaded numpy several-fold.  Built from native/Makefile at first
# use; numpy does the same relayout when the build fails.
_NATIVE = pathlib.Path(__file__).parents[3] / "native"
_STILE: object = None


def _build_stile() -> pathlib.Path | None:
    so = _NATIVE / "libstile.so"
    try:  # a no-op when the library is newer than tile.cpp
        r = subprocess.run(["make", "-C", str(_NATIVE), "libstile.so"],
                           capture_output=True, text=True)
        err = "" if r.returncode == 0 else (r.stderr or r.stdout).strip()
    except OSError as e:
        err = str(e)
    if err or not so.exists():
        print("[tiled] native/libstile.so did not build; relayout runs in "
              f"numpy: {err[-500:]}", file=sys.stderr)
        return None
    return so


def _stile():
    global _STILE
    if _STILE is None:
        _STILE = False
        so = (_build_stile() if os.environ.get("STPU_NATIVE_TILE", "1") == "1"
              else None)
        if so is not None:
            try:
                lib = ctypes.CDLL(str(so))
                lib.stile_transpose_pad_u32.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                    ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int,
                ]
                lib.stile_transpose_pad_u32.restype = None
                _STILE = lib
            except OSError as e:
                print(f"[tiled] cannot load {so}: {e}; relayout runs in "
                      "numpy", file=sys.stderr)
    return _STILE or None


class StwoTiledBatch(NamedTuple):
    # small per-proof arrays (normal layout) — transcript + OODS stages
    commitments: np.ndarray        # (B, 3, 8)
    oods_trace: np.ndarray         # (B, C, 4)
    oods_cp: np.ndarray            # (B, 16, 4)
    fri_first_commit: np.ndarray   # (B, 8)
    fri_inner_commits: np.ndarray  # (B, L-1, 8)
    fri_last: np.ndarray           # (B, 4)
    pow_nonce: np.ndarray          # (B, 2)
    # per-query arrays, tiled: lane = b * n_queries + q, padded to M*128
    trace_evals_t: np.ndarray      # (C, M, 128)
    cp_evals_t: np.ndarray         # (16, M, 128)
    trace_sibs_t: np.ndarray       # (D, 8, M, 128)
    cp_sibs_t: np.ndarray          # (D, 8, M, 128)
    fri_wits_t: np.ndarray         # (L, 4, M, 128)
    fri_sibs_t: np.ndarray         # (sum depths, 8, M, 128)


def n_tiles(batch: int, n_queries: int) -> int:
    """Row count M of the (..., M, 128) container for a B-proof batch:
    lanes padded to a whole kernel lane block."""
    lanes = batch * n_queries
    return -(-lanes // LANE_BLOCK) * LANE_BLOCK // LANES


def _tile_words(x: np.ndarray, m: int) -> np.ndarray:
    """(B, Q, ..., W) -> (..., W, M, 128): words major, lanes minor."""
    lead = x.shape[2:]
    n = x.shape[0] * x.shape[1]
    lib = _stile()
    if lib is not None and x.dtype == np.uint32:
        k = int(np.prod(lead)) if lead else 1
        xin = np.ascontiguousarray(x).reshape(n, k)
        out = np.empty((k, m * LANES), np.uint32)
        lib.stile_transpose_pad_u32(
            xin.ctypes.data, out.ctypes.data, n, k, m * LANES,
            os.cpu_count() or 2,
        )
        return out.reshape(lead + (m, LANES))
    flat = np.ascontiguousarray(
        np.moveaxis(x.reshape((-1,) + lead), 0, -1)
    )  # (..., W, B*Q)
    lanes = flat.shape[-1]
    pad = m * LANES - lanes
    if pad:
        flat = np.concatenate(
            [flat, np.zeros(flat.shape[:-1] + (pad,), flat.dtype)], axis=-1
        )
    return flat.reshape(flat.shape[:-1] + (m, LANES))


def tile_batch(proof: StwoProof, cfg: StwoConfig) -> StwoTiledBatch:
    """Host relayout of a stacked (B, ...) proof batch (numpy in/out)."""
    b = int(proof.trace_evals.shape[0])
    m = n_tiles(b, cfg.n_queries)
    to = lambda x: np.asarray(x, np.uint32)
    return StwoTiledBatch(
        commitments=to(proof.commitments),
        oods_trace=to(proof.oods_trace),
        oods_cp=to(proof.oods_cp),
        fri_first_commit=to(proof.fri_first_commit),
        fri_inner_commits=to(proof.fri_inner_commits),
        fri_last=to(proof.fri_last),
        pow_nonce=to(proof.pow_nonce),
        trace_evals_t=_tile_words(to(proof.trace_evals), m),
        cp_evals_t=_tile_words(to(proof.cp_evals), m),
        trace_sibs_t=_tile_words(to(proof.trace_sibs), m),
        cp_sibs_t=_tile_words(to(proof.cp_sibs), m),
        fri_wits_t=np.stack(
            [_tile_words(to(w), m) for w in proof.fri_witnesses]
        ),
        fri_sibs_t=np.concatenate(
            [_tile_words(to(s), m) for s in proof.fri_sibs], axis=0
        ),
    )
