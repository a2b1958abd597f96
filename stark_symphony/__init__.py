"""stark_symphony — a batched STARK verification framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
`starkware-bitcoin/stark-symphony` (reference mounted at /root/reference):

* ``ops``      — batched field arithmetic (M31/CM31/QM31 tower, F_{3*2^30+1}),
                 vectorized SHA-256, Merkle paths, circle-group geometry, NTT.
* ``models``   — the two verifier families: ``stwo`` (circle STARK over M31)
                 and ``stark101`` (univariate STARK over F_{3*2^30+1}),
                 plus host-side provers and proof containers.
* ``parallel`` — device-mesh sharding of proof batches and collective
                 accept/reject reduction.
* ``utils``    — packing/serialization helpers (u256 <-> u32 words, hex).

Design stance (vs the reference's SimplicityHL one-proof straight-line
programs): every primitive operates on arrays of proofs/queries/columns,
``vmap``/``pjit`` provide the parallel axes, and failures are boolean masks
reduced to an accept bitmap instead of aborts.  All integer math is uint32
(wide products use 16-bit limb decomposition).
"""

__version__ = "0.1.0"
