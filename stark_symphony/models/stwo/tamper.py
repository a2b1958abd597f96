"""The 15 tamper classes of a stwo proof, applied to one lane of a batch.

Every proof field class is covered (pow_nonce included: at PRODUCTION size
a nonce delta moves all 16 queries; collision probability ~2^-(5+16*13)).
Shared by the tests and chip_smoke.py, which put one class in each of
lanes 1..15 of a batch and require the bitmap to reject exactly those.
"""

from __future__ import annotations

import numpy as np

from .proof import StwoProof

# (field, mutation, index into the field's tuple of per-layer arrays)
PROD_TAMPERS = [
    ("trace_evals", lambda a: a + np.uint32(1), None),
    ("trace_sibs", lambda a: a ^ np.uint32(1), None),
    ("cp_evals", lambda a: a ^ np.uint32(1), None),
    ("cp_sibs", lambda a: a ^ np.uint32(4), None),
    ("oods_trace", lambda a: a ^ np.uint32(1), None),
    ("oods_cp", lambda a: a ^ np.uint32(2), None),
    ("fri_first_commit", lambda a: a ^ np.uint32(1), None),
    ("fri_inner_commits", lambda a: a ^ np.uint32(1), None),
    ("fri_last", lambda a: a ^ np.uint32(1), None),
    ("fri_witnesses", lambda a: a ^ np.uint32(1), 0),
    ("fri_witnesses", lambda a: a + np.uint32(1), 4),
    ("fri_sibs", lambda a: a ^ np.uint32(1), 0),
    ("fri_sibs", lambda a: a ^ np.uint32(2), 5),
    ("pow_nonce", lambda a: a + np.uint32(1), None),
    ("commitments", lambda a: a ^ np.uint32(1), None),
]


def tamper_batch_lane(batch: StwoProof, lane: int, field: str, mutate,
                      tuple_idx) -> StwoProof:
    """Apply a tamper to ONE proof (lane) of a stacked batch."""
    d = batch._asdict()
    if tuple_idx is None:
        arr = np.array(d[field])
        arr[lane] = mutate(arr[lane])
        d[field] = arr
    else:
        t = list(d[field])
        a = np.array(t[tuple_idx])
        a[lane] = mutate(a[lane])
        t[tuple_idx] = a
        d[field] = tuple(t)
    return StwoProof(**d)


def tamper_lanes(batch: StwoProof, tampers=PROD_TAMPERS) -> StwoProof:
    """Lane i (1..len(tampers)) gets tamper class i-1; lane 0 and every
    lane past the classes stay untampered."""
    for lane, (field, mutate, tuple_idx) in enumerate(tampers, 1):
        batch = tamper_batch_lane(batch, lane, field, mutate, tuple_idx)
    return batch
