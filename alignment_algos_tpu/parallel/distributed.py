"""Multi-host execution (jax.distributed) for library screens.

The reference has no distributed anything (SURVEY.md section 2.10); this is
the net-new multi-host layer demanded by BASELINE.md ("cell-updates/s at
1 chip / 1 host / N >= 2 hosts", ">= 80% queries/s efficiency at 4 hosts").

Design: one jax.distributed process group per host set.  After
``initialize()`` every process sees the same global device list; the screen
code (parallel/screen.py) already builds its arrays through
``make_array_from_callback`` and reads only replicated outputs, so the SAME
screen functions run unchanged on a multi-process mesh — the library shards
across all hosts' devices, each host computes its shard's scores with the
wavefront engine, and the deterministic top-k merge rides the collective
inserted by XLA.

Without a multi-host cluster the honest stand-in is a
multi-process CPU group over local TCP: ``launch_local_screen`` spawns N
processes, each with its own virtual CPU devices, initializes
jax.distributed against a local coordinator, runs the sharded screen, and
returns every process's replicated result for bit-equality checks against
the single-process path.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np

_ENV_COORD = "AAT_DIST_COORDINATOR"
_ENV_NPROC = "AAT_DIST_NUM_PROCESSES"
_ENV_PID = "AAT_DIST_PROCESS_ID"


def maybe_initialize_from_env() -> bool:
    """Initialize jax.distributed when the AAT_DIST_* env vars are set
    (returns True) — called by the screen CLI before touching devices."""
    coord = os.environ.get(_ENV_COORD)
    if not coord:
        return False
    import jax
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(os.environ[_ENV_NPROC]),
        process_id=int(os.environ[_ENV_PID]))
    return True


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker_main(argv: list[str]) -> int:
    """Entry point for one process of a local multi-process CPU group:
    initialize jax.distributed, run the sharded screen over the GLOBAL
    mesh, dump the replicated result."""
    spec = json.load(open(argv[0]))
    out_path = argv[1]

    import jax
    # a CPU-only emulation of a multi-process group for tests: the
    # workers never open the GPU, which the parent process may hold
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=spec["coordinator"],
        num_processes=spec["num_processes"],
        process_id=int(argv[2]))

    from .screen import default_mesh, screen_library

    data = np.load(spec["data"])
    n_total = spec["num_processes"] * spec["devices_per_process"]
    assert len(jax.devices()) == n_total, (
        f"global device count {len(jax.devices())} != {n_total}")
    mesh = default_mesh(n_total)
    import time as _time
    wall = None
    for _ in range(int(spec.get("reps", 1))):  # last rep is warm
        t0 = _time.perf_counter()
        scores, idx = screen_library(
            data["q_codes"], data["t_codes"], data["table"],
            float(spec["gi"]), float(spec["ge"]), k=int(spec["k"]),
            mesh=mesh, engine="xla")
        wall = _time.perf_counter() - t0
    np.savez(out_path, scores=scores, idx=idx,
             pid=np.int32(jax.process_index()),
             wall=np.float64(wall))
    return 0


def launch_local_screen(q_codes, t_codes, table, gi, ge, k,
                        num_processes: int = 2,
                        devices_per_process: int = 2,
                        timeout: float = 300.0, reps: int = 1,
                        return_walls: bool = False):
    """Run a sharded library screen as a REAL multi-process jax.distributed
    group (CPU backend, local TCP coordinator).  Returns the per-process
    (scores, idx) results — all of them must be identical, and identical to
    the single-process screen.  With ``return_walls`` also returns each
    process's warm screen wall time (the last of ``reps`` runs)."""
    tmp = tempfile.mkdtemp(prefix="aat_dist_")
    data_path = os.path.join(tmp, "inputs.npz")
    np.savez(data_path, q_codes=np.asarray(q_codes, np.int32),
             t_codes=np.asarray(t_codes, np.int32),
             table=np.asarray(table, np.float32))
    spec = {
        "coordinator": f"127.0.0.1:{free_port()}",
        "num_processes": num_processes,
        "devices_per_process": devices_per_process,
        "data": data_path,
        "gi": float(gi),
        "ge": float(ge),
        "k": int(k),
        "reps": int(reps),
    }
    spec_path = os.path.join(tmp, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)

    procs = []
    outs = []
    for pid in range(num_processes):
        out_path = os.path.join(tmp, f"out_{pid}.npz")
        outs.append(out_path)
        env = dict(os.environ)
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={devices_per_process}")
        env.pop("AAT_DIST_COORDINATOR", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "alignment_algos_tpu.parallel.distributed",
             spec_path, out_path, str(pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    results = []
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        errs.append(err)
        if p.returncode != 0:
            raise RuntimeError(
                f"distributed worker failed (rc={p.returncode}):\n"
                + "\n".join(errs[-1].splitlines()[-15:]))
    walls = []
    for out_path in outs:
        with np.load(out_path) as z:
            results.append((z["scores"].copy(), z["idx"].copy()))
            walls.append(float(z["wall"]) if "wall" in z else None)
    if return_walls:
        return results, walls
    return results


if __name__ == "__main__":
    sys.exit(_worker_main(sys.argv[1:]))
