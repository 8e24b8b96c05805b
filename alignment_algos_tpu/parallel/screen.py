"""Device-mesh library screening (the scale-out layer; net-new design —
the reference is single-threaded, SURVEY.md section 2.10).

A template library is sharded over the mesh's library axis; every device
scores its shard against its block of queries; the per-query top-K
merges across shards with deterministic tie-breaking (score descending,
then template id ascending — mirroring sortSet's stable ranking
semantics).  The mesh follows the algorithm alone: 8 virtual CPU devices
in tests, the GPUs of one host (all joined by NVLink) in production.

Engine choice is one rule, keyed on the mesh's platform (never on the
process's default device): a GPU mesh runs the Triton strip kernel
(ops/swscan) and the on-device HMAP producer (ops/hmap_device); a CPU
mesh runs the plain XLA engines.  An explicit ``engine`` always wins.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import swaffine, swscan

SCREEN_ENGINES = ("triton", "xla")


def _devices(n: int | None) -> list:
    devs = jax.devices()
    if n is not None:
        if len(devs) < n:
            raise ValueError(f"need {n} devices, have {len(devs)} "
                             f"{devs[0].platform} device(s)")
        devs = devs[:n]
    return devs


def default_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (all when None)."""
    return Mesh(np.array(_devices(n_devices)), axis_names=(axis,))


def grid_mesh(shape: tuple[int, int], axes=("qb", "lib")) -> Mesh:
    """2-D mesh: query batches on one axis, library shards on the other."""
    devs = _devices(shape[0] * shape[1])
    return Mesh(np.array(devs).reshape(shape), axis_names=axes)


def on_gpu(mesh: Mesh) -> bool:
    return mesh.devices.flat[0].platform == "gpu"


def pick_engine(mesh: Mesh, gi: float, ge: float) -> str:
    """The substitution-screen engine for ``mesh``: "triton" on a GPU
    mesh when the kernel's gap gate holds, else "xla"."""
    return "triton" if on_gpu(mesh) and swscan.supported(gi, ge) else "xla"


def _put(mesh: Mesh, arr, spec) -> jax.Array:
    """Place a host-replicated numpy array onto the mesh with the given
    PartitionSpec.  Uses make_array_from_callback, which works identically
    in single-process and multi-process (jax.distributed) runs: every
    process passes the same full array and contributes only the shards its
    local devices own."""
    sh = NamedSharding(mesh, spec)
    arr = np.asarray(arr)
    return jax.make_array_from_callback(arr.shape, sh, lambda idx: arr[idx])


def _pad_rows(codes: np.ndarray, shards: int):
    """Pad the leading axis to a multiple of the shard count with code-0
    rows (masked out of the top-k / dropped on return)."""
    n = codes.shape[0]
    padded = -(-n // shards) * shards
    if padded != n:
        pad = np.zeros((padded - n, codes.shape[1]), dtype=codes.dtype)
        codes = np.concatenate([codes, pad], axis=0)
    return codes, n


def _int8_exact(table) -> bool:
    tbl = np.asarray(table)
    return bool(np.all(tbl == np.round(tbl)) and np.abs(tbl).max() < 127)


def _engine_scores(engine: str, q: int, t: int, int8_sim: bool,
                   interpret: bool):
    """One query (Q,) against a local library block (b, T) -> (b,)."""
    if engine == "triton":
        return lambda qc, tblk, tbl, gap: swscan.sw_strip_scores(
            qc, tblk, tbl, gap, interpret=interpret)

    def xla(qc, tblk, tbl, gap):
        b = tblk.shape[0]
        qb = jnp.broadcast_to(qc[None, :], (b, q))
        sd = swaffine.skewed_similarity_from_codes(
            qb, tblk, tbl, sim_dtype=jnp.int8 if int8_sim else jnp.float32)
        return swaffine.sw_affine_scores_xla(sd, gap, q=q, t=t)[:b]
    return xla


@functools.lru_cache(maxsize=32)
def _screen_fn(mesh: Mesh, engine: str, q: int, t: int, k: int,
               int8_sim: bool):
    """Jitted all-pairs screen on a 2-D (qb, lib) mesh: shard_map runs the
    engine on each device's query block x library shard (queries in a
    scan), then the per-query top-k over the library axis is the
    cross-shard merge, replicated on every device and process."""
    qb_ax, lib_ax = mesh.axis_names
    # an explicit "triton" on a CPU mesh runs the kernel in the Pallas
    # interpreter (rehearsing the sharded kernel path on virtual devices);
    # pick_engine never chooses it there
    one = _engine_scores(engine, q, t, int8_sim, interpret=not on_gpu(mesh))

    def local(qblk, tblk, tbl, gap):
        return jax.lax.scan(
            lambda c, qc: (c, one(qc, tblk, tbl, gap)), 0, qblk)[1]

    scores_fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(qb_ax, None), P(lib_ax, None), P(), P()),
        out_specs=P(qb_ax, lib_ax),
        check_vma=False)  # pallas outputs carry no vma info

    def step(qd, td, tab, gap, valid):
        scores = scores_fn(qd, td, tab, gap)
        masked = jnp.where(valid[None, :], scores, jnp.float32(-3e38))
        # top_k returns the lower index first among equal keys
        ts, ti = jax.lax.top_k(masked, k)
        return scores, ts, ti

    repl = NamedSharding(mesh, P())
    return jax.jit(step, out_shardings=(
        NamedSharding(mesh, P(qb_ax, lib_ax)), repl, repl))


def _screen_call(mesh: Mesh, q_codes, t_codes, table, gi, ge, k, engine):
    """(jitted screen step, its device arguments, nq, nt)."""
    qb_ax, lib_ax = mesh.axis_names
    q_codes = np.asarray(q_codes, dtype=np.int32)
    t_codes = np.asarray(t_codes, dtype=np.int32)
    nq, q = q_codes.shape
    nt, t = t_codes.shape
    k = min(k, nt)
    if engine is None:
        engine = pick_engine(mesh, gi, ge)
    if engine not in SCREEN_ENGINES:
        raise ValueError(f"unknown screen engine {engine!r}")
    q_codes, _ = _pad_rows(q_codes, int(mesh.shape[qb_ax]))
    t_codes, _ = _pad_rows(t_codes, int(mesh.shape[lib_ax]))
    args = (_put(mesh, q_codes, P(qb_ax, None)),
            _put(mesh, t_codes, P(lib_ax, None)),
            _put(mesh, np.asarray(table, np.float32), P()),
            _put(mesh, np.array([[gi, ge]], np.float32), P()),
            _put(mesh, np.arange(t_codes.shape[0]) < nt, P(lib_ax)))
    return _screen_fn(mesh, engine, q, t, k, _int8_exact(table)), args, nq, nt


def _screen(mesh: Mesh, q_codes, t_codes, table, gi, ge, k, engine):
    fn, args, nq, nt = _screen_call(mesh, q_codes, t_codes, table, gi, ge,
                                    k, engine)
    return fn(*args), nq, nt


def screen_library(q_codes: np.ndarray, t_codes: np.ndarray,
                   table: np.ndarray, gi: float, ge: float, k: int = 10,
                   mesh: Mesh | None = None, engine: str | None = None):
    """One query against a sharded template library.

    q_codes: (Q,) int codes; t_codes: (N, T) int codes (padded per template);
    returns (scores, indices) of the global top-k, identical on every host.
    engine: None = ``pick_engine``, or one of SCREEN_ENGINES.
    """
    if mesh is None:
        mesh = default_mesh()
    grid = Mesh(mesh.devices.reshape(1, -1),
                axis_names=("qb",) + tuple(mesh.axis_names))
    (_, ts, ti), _, _ = _screen(grid, np.asarray(q_codes)[None], t_codes,
                                table, gi, ge, k, engine)
    return np.asarray(ts)[0], np.asarray(ti)[0]


def screen_grid(q_codes: np.ndarray, t_codes: np.ndarray, table: np.ndarray,
                gi: float, ge: float, k: int = 5,
                mesh: Mesh | None = None, engine: str | None = None):
    """Many queries x sharded library on a 2-D (qb, lib) mesh.

    Returns (scores (nq, nt), topk_scores (nq, k), topk_idx (nq, k)).
    engine: None = ``pick_engine``, or one of SCREEN_ENGINES.
    """
    if mesh is None:
        mesh = grid_mesh((1, len(jax.devices())))
    (scores, ts, ti), nq, nt = _screen(mesh, q_codes, t_codes, table, gi,
                                       ge, k, engine)
    return (np.asarray(scores)[:nq, :nt], np.asarray(ts)[:nq],
            np.asarray(ti)[:nq])


def _sharded_bucket_scores(batch, mesh: Mesh,
                           local: bool = False) -> np.ndarray:
    """Optimal global scores for one same-shape bucket of cost models,
    sharded over the mesh's first axis with shard_map: every device runs
    the exact scores engine (ops/dp_scores) on its slice of the batch; the
    gathered scores are bit-identical to a single-device run because each
    pair's computation is unchanged — sharding only partitions the batch
    axis."""
    from ..ops import dp_scores

    axis = mesh.axis_names[0]
    ndev = int(mesh.devices.size)
    n = len(batch)
    npad = -(-n // ndev) * ndev
    args, kw = dp_scores.pack_costs(list(batch) + [batch[0]] * (npad - n))

    def local_fn(S, D, A, Bv, C, z):
        return dp_scores.batch_scores(S, D, A, Bv, C, z, local=local, **kw)

    fn = jax.shard_map(local_fn, mesh=mesh,
                       in_specs=tuple(P(axis) for _ in args) + (P(),),
                       out_specs=P(axis))
    z = _put(mesh, np.uint32(0), P())
    dev = [_put(mesh, a, P(axis)) for a in args]
    return np.asarray(jax.jit(fn)(*dev, z))[:n]


def profile_engine(mesh: Mesh, ev0) -> str:
    """The exact profile-screen engine for ``mesh``: "device" (similarity
    built and scored on the card, ops/hmap_device) for HMAP-family
    evaluators on a one-device GPU mesh, else "host" (host cost builds,
    device scores)."""
    from ..scoring.hmap2_eval import Hmap2Eval
    from ..scoring.hmap_eval import HMAPaliEval
    if not on_gpu(mesh) or mesh.devices.size > 1:
        return "host"
    hmap = isinstance(ev0, HMAPaliEval) and type(ev0).build_costs in (
        HMAPaliEval.build_costs, Hmap2Eval.build_costs)
    return "device" if hmap else "host"


def screen_profiles(query, templates, evaluator_factory, k: int = 10,
                    engine: str | None = None, mesh: Mesh | None = None):
    """Exact-scoring profile screen: one HMAP query against a list of
    template profiles, with reference scoring (bit-equal to per-pair
    DPMatrix builds).  Templates are bucketed by length (the engines
    require same-shape cost models per batch).

    engine: "device" = similarity built and scored on device
    (ops/hmap_device; HMAP-family evaluators only), "host" = cost models
    built on host, scored on device by ops/dp_scores; None =
    ``profile_engine``.

    mesh: shard each shape bucket of the "host" engine over the mesh's
    first axis (shard_map; per-shard exact scoring, bit-identical to
    single-device).  None = one device.

    evaluator_factory(query, templ) -> evaluator with build_costs().
    Returns (scores, order) — optimal global scores and the top-k template
    indices (score desc, index asc).
    """
    from ..ops import dp_scores

    if mesh is None:
        mesh = default_mesh(1)
    ev0 = evaluator_factory(query, templates[0])
    if engine is None:
        engine = profile_engine(mesh, ev0)
    if engine == "device":
        from ..ops import hmap_device
        return hmap_device.screen_hmap_device(query, templates, ev0.params,
                                              k=k, ev=ev0)
    if engine != "host":
        raise ValueError(f"unknown profile engine {engine!r}")

    buckets: dict[tuple[int, int], list[int]] = {}
    costs = [None] * len(templates)
    for idx, templ in enumerate(templates):
        ev = evaluator_factory(query, templ)
        c = ev.build_costs(query, templ)
        costs[idx] = c
        buckets.setdefault((c.q_size, c.t_size), []).append(idx)

    scores = np.zeros(len(templates), dtype=np.float32)
    for idxs in buckets.values():
        batch = [costs[i] for i in idxs]
        if mesh.devices.size > 1:
            scores[idxs] = _sharded_bucket_scores(batch, mesh)
        else:
            scores[idxs] = dp_scores.forward_scores_batch(batch)
    order = np.lexsort((np.arange(len(scores)), -scores))[:k]
    return scores, order


def screen_library_host(q_codes, t_codes, table, gi, ge, k=10):
    """Single-device reference for testing the sharded path."""
    scores = np.asarray(swaffine.sw_affine_batch_xla(
        jnp.broadcast_to(jnp.asarray(q_codes, jnp.int32)[None, :],
                         (t_codes.shape[0], len(q_codes))),
        jnp.asarray(t_codes, jnp.int32), jnp.asarray(table), gi, ge))
    order = np.lexsort((np.arange(len(scores)), -scores))
    top = order[:k]
    return scores[top], top
