"""Multi-host (multi-controller) runtime harness.

The reference is single-process (SURVEY.md §2.4: no distributed backend
exists).  Here every host runs the same program: ONE process per host,
driving all of that host's cards (a second JAX process on a card fails for
want of memory: each reserves most of the card when it starts).
`jax.distributed.initialize` wires the coordination service, and the
(dp, tp) mesh spans all hosts' devices; collectives run over NCCL.

Launch pattern (one command per host):

    STPU_COORDINATOR=host0:8476 STPU_NUM_PROCESSES=4 STPU_PROCESS_ID=$i \
        python bench_scaling.py

Single-process runs (no env set) skip initialization, so every entry
point works unchanged on one host.
"""

from __future__ import annotations

import os

_INITIALIZED = False


def initialize_from_env() -> bool:
    """Initialize the multi-controller runtime from STPU_* env vars.

    Returns True if a multi-process runtime was (or already is) set up,
    False for single-process runs.  Idempotent.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return True
    coord = os.environ.get("STPU_COORDINATOR")
    if not coord:
        return False
    import jax

    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(os.environ.get("STPU_NUM_PROCESSES", "1")),
        process_id=int(os.environ.get("STPU_PROCESS_ID", "0")),
        # default 300 s: on oversubscribed hosts (CI, 2-core test boxes)
        # peer startup can straggle past it while other suites compile
        initialization_timeout=int(
            os.environ.get("STPU_INIT_TIMEOUT", "900")),
    )
    _INITIALIZED = True
    return True


def initialize_single(port: int = 0) -> None:
    """Explicitly initialize a 1-process coordination service (exercises
    the full multi-controller code path on one host; used by tests)."""
    global _INITIALIZED
    if _INITIALIZED:
        return
    import socket

    import jax

    if port == 0:
        s = socket.socket()
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
        s.close()
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=1,
        process_id=0,
    )
    _INITIALIZED = True


def global_mesh(tp: int = 1):
    """A (dp, tp) mesh over every device of every process.

    With multiple hosts, `jax.devices()` already enumerates the global
    device set after initialize, host-major; the only collective of the
    DP path is the accept-count psum.
    """
    import jax

    from ..parallel.batch import make_mesh

    return make_mesh(len(jax.devices()), tp=tp)


def process_count() -> int:
    import jax

    return jax.process_count()


def barrier(name: str, timeout_s: int = 600) -> None:
    """Block until every process reaches this barrier (coordination
    service TCP barrier, NOT a device collective).

    Needed before the FIRST collective of a freshly compiled program:
    each process compiles independently, and collective rendezvous
    windows are short (~30 s for Gloo's key-value exchange) — if one process
    finishes compiling a minute after the other, the early one's
    collective times out.  A named barrier with a generous timeout
    absorbs arbitrary compile skew."""
    from jax._src import distributed as _dist

    client = _dist.global_state.client
    assert client is not None, "jax.distributed must be initialized"
    client.wait_at_barrier(name, timeout_in_ms=timeout_s * 1000)


def local_batch_slice(global_batch: int):
    """This process's slice of a global proof batch: (start, size).

    Hosts feed per-process shards via jax.make_array_from_process_local_data
    or equivalent; this helper keeps the split convention in one place.
    """
    import jax

    n = jax.process_count()
    i = jax.process_index()
    assert global_batch % n == 0, "process count must divide global batch"
    per = global_batch // n
    return i * per, per
