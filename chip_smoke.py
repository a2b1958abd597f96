"""Smoke run of the batched stwo verifier on one GPU (``--multi``: four).

    python chip_smoke.py            # one card
    python chip_smoke.py --multi    # four cards: the DP path only

One process; nothing here starts another JAX process.  Phases (any failure
exits non-zero before the result line):

1. Device: the backend must be a GPU (no CPU fallback); prints the JAX
   version, device kind, and the card's name and power limit.
2. Kernel parity at real widths: each stage kernel (ops/pallas/gpu_stages.py)
   against its plain XLA form, on the tiled PRODUCTION batch (65,536 query
   lanes, tamper lanes included, so `ok` takes both values) and on one
   random-input case.  The whole path is integer-only (SHA-256 and
   M31/QM31 arithmetic, no floating point), so TF32 and summation order do
   not apply: the comparison is exact equality of ok, folded and q_out
   (tolerance 0).
3. Main path: the 15 tamper classes in lanes 1..15 of a 4,096-proof
   PRODUCTION batch (the repo's 256 committed distinct proofs, cycled);
   `tiled.tile_batch` then `verify_batch_tiled` must reject exactly lanes
   1..15 and equal the standard path `verify_batch` lane for lane; then
   `__graft_entry__.entry()` must accept.
4. Record (not a claim): compile seconds per executable, steady ms per
   batch over 7 runs ended by block_until_ready, proofs/s and peak device
   memory, for the tiled path with the kernels, the tiled path with the
   kernels' plain XLA forms, and the standard path.

The last line of standard output is the JSON result
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
N_RUNS = 7


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """`name, power.limit` of the first card, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def setup_jax():
    import jax

    jax.config.update(
        "jax_compilation_cache_dir",
        os.environ.get("JAX_COMPILATION_CACHE_DIR", str(ROOT / ".jax_cache")))
    return jax


def device_phase(jax) -> str:
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found "
                         f"{devs[0].platform!r}")
    card = card_line()
    log(f"jax {jax.__version__}; {len(devs)} x {devs[0].device_kind}")
    log(f"card: {card}")
    return card


def load_batch(cfg, batch_size: int, n_distinct: int = 256):
    """`batch_size` proofs cycled from `n_distinct` committed distinct
    proofs, with tamper class i-1 in lane i (i = 1..15)."""
    from stark_symphony.models.stwo import proof as P
    from stark_symphony.models.stwo.tamper import tamper_lanes
    from stark_symphony.utils.proofcache import cached_stwo_proof

    proofs = [cached_stwo_proof(cfg, seed=s) for s in range(n_distinct)]
    batch = P.stack([proofs[i % n_distinct] for i in range(batch_size)])
    return tamper_lanes(batch)


def compile_timed(jax, fn, *args):
    t = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t


def steady_ms(jax, compiled, *args) -> list[float]:
    jax.block_until_ready(compiled(*args))
    ts = []
    for _ in range(N_RUNS):
        t = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        ts.append((time.perf_counter() - t) * 1e3)
    return ts


def _equal(a, b) -> bool:
    import numpy as np

    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))


def _statics(cfg):
    depths = tuple(cfg.fri_layer_depth(l)
                   for l in range(1 + cfg.n_inner_layers))
    return ((cfg.n_columns, cfg.lde_log_size),
            (cfg.n_cp_partitions, cfg.lde_log_size), (depths,))


def stage_executables(jax, tb, cfg, card: str):
    """The tiled path in separately compiled pieces: the XLA stages (I-IV,
    VI) that build the kernels' arguments, the three stage-kernel calls,
    their plain XLA forms, and the bitmap reduction.  Returns
    (args, kernel_fns, reference_fns, bitmap_fn)."""
    from stark_symphony.models.stwo import verifier
    from stark_symphony.ops.pallas import gpu_stages as GS

    def arrays(t):  # transcript masks + the kernels' array arguments
        masks, (trace_v, cp_v), fri_vii = verifier.tiled_stage_args(t, cfg)
        return masks, (trace_v[:4], cp_v[:4], fri_vii[:7])

    c_args, c_s = compile_timed(jax, arrays, tb)
    masks, args = c_args(tb)
    log(f"record compile tiled XLA stages (I-IV, VI): {c_s:.2f} s "
        f"| card: {card}")
    kerns, refs = [], []
    for (arr, static), kern, ref, name in zip(
            zip(args, _statics(cfg)),
            (GS.leafwalk, GS.leafwalk, GS.fri_layers),
            (GS.leafwalk_reference, GS.leafwalk_reference,
             GS.fri_reference),
            ("stwo_stage5_leafwalk[trace]", "stwo_stage5_leafwalk[cp]",
             "stwo_stage7_fri")):
        k, k_s = compile_timed(jax, lambda *a, f=kern, s=static: f(*a, *s),
                               *arr)
        r, r_s = compile_timed(jax, lambda *a, f=ref, s=static: f(*a, *s),
                               *arr)
        log(f"record compile {name}: kernel {k_s:.2f} s, plain XLA form "
            f"{r_s:.2f} s | card: {card}")
        kerns.append(k)
        refs.append(r)

    def bitmap(t, m, ok_t, ok_c, fri_out):
        return verifier.tiled_bitmap(t, cfg, m, ok_t, ok_c, fri_out)

    outs = [f(*a) for f, a in zip(kerns, args)]
    c_bitmap, _ = compile_timed(jax, bitmap, tb, masks, *outs)
    return c_args, args, kerns, refs, c_bitmap


def parity_phase(args, kerns, refs, cfg) -> None:
    """Each kernel vs its plain XLA form, exact, at the batch's widths: on
    the tiled batch's own kernel arguments, then on random inputs."""
    import numpy as np

    lanes = int(np.prod(args[2][0].shape))
    names = ("stwo_stage5_leafwalk[trace]", "stwo_stage5_leafwalk[cp]",
             "stwo_stage7_fri")
    cases = list(zip(names, kerns, refs, args))
    rand = random_cases(args[2][0].shape[-2], cfg)
    cases += [("random " + names[0], kerns[0], refs[0], rand[0]),
              ("random " + names[2], kerns[2], refs[2], rand[1])]
    for name, kern, ref, arr in cases:
        k, r = kern(*arr), ref(*arr)
        k = k if isinstance(k, tuple) else (k,)
        r = r if isinstance(r, tuple) else (r,)
        values = sorted(set(np.unique(np.asarray(k[0])).tolist()))
        equal = _equal(k, r)
        log(f"parity {name}: {lanes} lanes, ok values {values}, exact "
            f"equality of {len(k)} output(s) (tolerance 0): {equal}")
        if not equal:
            raise SystemExit(f"kernel parity failed: {name}")
        if name != "random " + names[2] and values != [0, 1]:
            raise SystemExit(f"{name}: ok does not take both values")


def random_cases(m: int, cfg):
    """Random array arguments of the trace leafwalk and of the FRI kernel
    at the same widths; a third of the stage-V roots are the true ones."""
    import jax.numpy as jnp
    import numpy as np

    from stark_symphony.ops import merkle
    from stark_symphony.ops.sha256 import sha256_words

    rng = np.random.default_rng(0)
    u = lambda *s: rng.integers(0, 1 << 32, size=s, dtype=np.uint32)
    p = 0x7FFFFFFF
    d = cfg.lde_log_size
    ev, idx, sibs = u(cfg.n_columns, m, 128), u(1, m, 128) % (1 << d), \
        u(d, 8, m, 128)
    root = merkle.compute_root(
        sha256_words(jnp.moveaxis(jnp.asarray(ev), 0, -1)),
        jnp.asarray(idx[0]), jnp.moveaxis(jnp.asarray(sibs), (0, 1), (-2, -1)))
    root = np.array(jnp.moveaxis(root, -1, 0))
    root[0].reshape(-1)[rng.random(m * 128) < 2 / 3] ^= 1
    depths = tuple(cfg.fri_layer_depth(l)
                   for l in range(1 + cfg.n_inner_layers))
    n_l = len(depths)
    fri = (u(1, m, 128) % (1 << d), u(4, m, 128) % p, u(n_l, 4, m, 128) % p,
           u(n_l, m, 128) % p, u(n_l, 4, m, 128) % p,
           u(sum(depths), 8, m, 128), u(n_l, 8, m, 128))
    return (ev, idx, sibs, root), fri


def _record(name, ts, b, card, compile_s=None):
    med = sorted(ts)[len(ts) // 2]
    c = "" if compile_s is None else f"compile {compile_s:.2f} s; "
    log(f"record {name}: {c}steady ms/batch over {len(ts)} runs "
        f"{[round(x, 3) for x in ts]}, median {med:.3f}; "
        f"{b / (med / 1e3):.0f} proofs/s (B={b}) | card: {card}")


def main_path_phase(jax, batch, cfg, card: str) -> None:
    import numpy as np

    from stark_symphony.models.stwo import tiled, verifier

    b = batch.commitments.shape[0]
    t = time.perf_counter()
    tb = tiled.tile_batch(batch, cfg)
    log(f"record host tile_batch: {(time.perf_counter() - t) * 1e3:.1f} ms "
        f"for {b} proofs | card: {card}")
    tb = jax.device_put(tb)
    c_args, args, kerns, refs, c_bitmap = stage_executables(
        jax, tb, cfg, card)
    parity_phase(args, kerns, refs, cfg)

    # the tiled path as its pieces, stage forms side by side (same XLA
    # stages and reduction; only stages V and VII differ)
    bitmaps = {}
    for form, fns in (("stage kernels", kerns), ("plain XLA stages", refs)):
        def run(t, fns=fns):
            masks, a = c_args(t)
            return c_bitmap(t, masks, *[f(*x) for f, x in zip(fns, a)])

        bitmaps[f"tiled path in pieces, {form}"] = np.asarray(run(tb))
        _record(f"tiled path in pieces, {form}", steady_ms(jax, run, tb), b,
                card)

    dbatch = jax.device_put(batch)
    for name, fn, arg in (
            ("tiled path verify_batch_tiled",
             lambda t: verifier.verify_batch_tiled(t, cfg), tb),
            ("standard path verify_batch",
             lambda x: verifier.verify_batch(x, cfg), dbatch)):
        compiled, c_s = compile_timed(jax, fn, arg)
        bitmaps[name] = np.asarray(compiled(arg))
        _record(name, steady_ms(jax, compiled, arg), b, card, c_s)
    want = np.ones(b, bool)
    want[1:16] = False
    for name, bm in bitmaps.items():
        rejected = np.flatnonzero(~bm).tolist()
        log(f"main path {name}: rejects lanes {rejected}")
        if not np.array_equal(bm, want):
            raise SystemExit(f"{name}: must reject exactly lanes 1..15")
    same = np.array_equal(bitmaps["tiled path verify_batch_tiled"],
                          bitmaps["standard path verify_batch"])
    log(f"main path: verify_batch_tiled bitmap == verify_batch bitmap lane "
        f"for lane: {same}")

    sys.path.insert(0, str(ROOT))
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    out = np.asarray(jax.jit(fn)(*args))
    log(f"__graft_entry__.entry(): accepts {int(out.sum())}/{out.size}")
    if not out.all():
        raise SystemExit("__graft_entry__.entry() rejected a valid proof")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"record peak_bytes_in_use: {peak} | card: {card}")


def multi_phase(jax, batch, cfg, card: str) -> None:
    """DP over make_mesh(4) vs one card on the same proofs."""
    import numpy as np

    from stark_symphony.models.stwo import verifier
    from stark_symphony.parallel.batch import make_mesh, verify_batch_dp

    n_dev = 4
    if len(jax.devices()) < n_dev:
        raise SystemExit(f"--multi needs {n_dev} devices, have "
                         f"{len(jax.devices())}")
    b = batch.commitments.shape[0]
    mesh = make_mesh(n_dev, tp=1)
    t = time.perf_counter()
    bitmap, n_ok = verify_batch_dp(batch, cfg, mesh)
    jax.block_until_ready(bitmap)
    log(f"record verify_batch_dp first call (compile + run): "
        f"{time.perf_counter() - t:.2f} s | card: {card}")
    devices = {s.device for s in bitmap.addressable_shards}
    log(f"multi: bitmap shards on {len(devices)} distinct devices "
        f"{sorted(d.id for d in devices)}")
    if len(devices) != n_dev:
        raise SystemExit("bitmap shards are not on 4 distinct devices")
    t = time.perf_counter()
    for _ in range(N_RUNS):
        bitmap, n_ok = verify_batch_dp(batch, cfg, mesh)
        jax.block_until_ready(bitmap)
    dp_ms = (time.perf_counter() - t) * 1e3 / N_RUNS
    single = np.asarray(jax.jit(lambda x: verifier.verify_batch(x, cfg))(
        jax.device_put(batch, jax.devices()[0])))
    n_ok = int(np.asarray(n_ok).reshape(-1)[0])
    equal = np.array_equal(np.asarray(bitmap), single)
    log(f"multi: dp bitmap == single-card bitmap: {equal}; n_ok {n_ok} "
        f"(want {b - 15})")
    log(f"record verify_batch_dp: {dp_ms:.3f} ms/batch incl. host "
        f"placement ({N_RUNS} calls, B={b}, {b // n_dev} per card) "
        f"| card: {card}")
    if not equal or n_ok != b - 15:
        raise SystemExit("multi: DP result differs from one card")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-card DP phase")
    ap.add_argument("--batch", type=int, default=4096)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    try:
        import stark_symphony  # noqa: F401
    except ImportError:
        print("chip_smoke: run from a checkout of the repo "
              "(stark_symphony not found)", file=sys.stderr)
        return 2
    jax = setup_jax()
    card = device_phase(jax)
    from stark_symphony.models.stwo.config import PRODUCTION

    t = time.perf_counter()
    batch = load_batch(PRODUCTION, args.batch)
    log(f"record proof load + stack + tamper: "
        f"{time.perf_counter() - t:.1f} s for {args.batch} proofs")
    if args.multi:
        multi_phase(jax, batch, PRODUCTION, card)
    else:
        main_path_phase(jax, batch, PRODUCTION, card)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
