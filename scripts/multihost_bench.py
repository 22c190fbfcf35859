"""Multi-process scaling curve (VERDICT r4 item 10 / scalebench analog,
reference ``scripts/run.sh:306-330``, NUM_RUNS protocol).

Times vertex-sharded PageRank supersteps on a ladder of graph sizes
over FOUR devices, arranged three ways:

* 1 process x 4 virtual CPU devices (all collectives in-process),
* 2 processes x 2 devices (collectives cross one process boundary
  over jax.distributed/gloo — the multi-host runtime path),
* 4 processes x 1 device (every collective hop crosses processes).

Efficiency = t_1proc / t_Nproc isolates cross-process collective
overhead — the best multi-host proxy this single-machine image allows
(all processes share the same CPU; a real 2-host number needs real
hosts).  North star: >= 0.8 at the LJ-class operating point;
the small-graph points EXPECT low efficiency (fixed ~50 ms gloo
superstep latency, recorded honestly in BASELINE.md).

Usage:
  python scripts/multihost_bench.py                  # full curve
  python scripts/multihost_bench.py quick            # largest size only
  python scripts/multihost_bench.py worker <pid> <nprocs> <port> <n> <e>
"""
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ITERS = 40
SIZES = [(100_000, 1_000_000), (400_000, 4_000_000),
         (1_000_000, 10_000_000), (2_000_000, 20_000_000)]
# `lj` mode: the actual LJ-scale operating point, reusing bench.py's
# cached edge list so the 5 processes don't regenerate 69M RMAT edges
LJ_SIZE = (4_800_000, 69_000_000)
LJ_EDGES = os.path.join(REPO, "data", "rmat_lj.npz")


def _build(n, e):
    import numpy as np
    from green_marl_tpu.graph import generate as gen
    from green_marl_tpu.graph.csr import from_edges
    if (n, e) == LJ_SIZE:
        if not os.path.exists(LJ_EDGES):
            # a silent seed-13 fallback would record an "LJ point"
            # measured on a different graph
            raise SystemExit(
                "lj mode needs bench.py's cached edge list "
                f"({LJ_EDGES}); run `python bench.py` once first")
        z = np.load(LJ_EDGES)
        src, dst = z["src"], z["dst"]
    else:
        src, dst = gen.rmat_edges(n, e, seed=13)
    g, _ = from_edges(src, dst, n)
    return g


def _time_pagerank(vsg, mesh, V):
    import numpy as np
    import jax
    rank, diff, it = V.pagerank_vsharded(vsg, mesh, e=0.0, d=0.85,
                                         max_iter=ITERS)
    np.asarray(jax.device_get(diff))          # warm compile + run
    t0 = time.time()
    rank, diff, it = V.pagerank_vsharded(vsg, mesh, e=1e-30, d=0.85,
                                         max_iter=ITERS)
    np.asarray(jax.device_get(diff))
    return time.time() - t0, int(it)


def worker(pid: int, nprocs: int, port: int, n: int, e: int):
    from green_marl_tpu.parallel import multihost as mh
    local = 4 // nprocs
    # NOTE: vertex_sharded must be imported AFTER mh.init — its
    # module-level jnp constants would initialize the XLA backend,
    # which jax.distributed.initialize forbids
    mh.init(coordinator_address=f"127.0.0.1:{port}",
            num_processes=nprocs, process_id=pid,
            local_cpu_devices=local)
    from green_marl_tpu.parallel import vertex_sharded as V
    import jax
    assert len(jax.devices()) == 4
    g = _build(n, e)
    vsg = V.build_vertex_sharded(g, 4)
    mesh = mh.global_mesh()
    vsg = mh.place_multihost(vsg, mesh)
    dt, it = _time_pagerank(vsg, mesh, V)
    print(f"MHBENCH pid={pid} nprocs={nprocs} iters={it} "
          f"time={dt:.3f}", flush=True)


def single_process(n, e) -> float:
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import scripts.multihost_bench as B\n"
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "from green_marl_tpu.parallel import vertex_sharded as V\n"
        "g = B._build(%d, %d)\n"
        "mesh = V.vmesh(4)\n"
        "vsg = V.place(V.build_vertex_sharded(g, 4), mesh)\n"
        "dt, it = B._time_pagerank(vsg, mesh, V)\n"
        "print(f'MHBENCH pid=0 nprocs=1 iters={it} time={dt:.3f}')\n"
        % (REPO, n, e))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=1800)
    if out.returncode != 0:
        raise SystemExit(f"1-proc run failed:\n{out.stderr[-3000:]}")
    for line in out.stdout.splitlines():
        if line.startswith("MHBENCH"):
            return float(line.split("time=")[1])
    raise SystemExit("1-proc run produced no MHBENCH line")


def multi_process(nprocs, n, e) -> float:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    # workers are CPU processes (mh.init forces local_cpu_devices); on a
    # GPU host an unpinned worker would also open every card
    env["JAX_PLATFORMS"] = "cpu"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", str(pid),
         str(nprocs), str(port), str(n), str(e)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=env) for pid in range(nprocs)]
    times = []
    for p in procs:
        out, _ = p.communicate(timeout=1800)
        if p.returncode != 0:
            raise SystemExit(f"worker failed:\n{out[-3000:]}")
        for line in out.splitlines():
            if line.startswith("MHBENCH"):
                times.append(float(line.split("time=")[1]))
    return max(times)


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
               int(sys.argv[5]), int(sys.argv[6]))
        return
    if len(sys.argv) > 1 and sys.argv[1] == "quick":
        sizes = SIZES[-1:]
    elif len(sys.argv) > 1 and sys.argv[1] == "lj":
        sizes = [LJ_SIZE]
    else:
        sizes = SIZES
    rows = []
    for n, e in sizes:
        t1 = single_process(n, e)
        row = {"n": n, "e": e, "t_1proc_s": round(t1, 3)}
        for np_ in (2, 4):
            tn = multi_process(np_, n, e)
            row[f"t_{np_}proc_s"] = round(tn, 3)
            row[f"eff_{np_}proc"] = round(t1 / tn, 3)
        rows.append(row)
        print(f"# N={n} E={e}: 1p {t1:.2f}s  "
              f"2p {row['t_2proc_s']:.2f}s (eff {row['eff_2proc']:.3f})  "
              f"4p {row['t_4proc_s']:.2f}s (eff {row['eff_4proc']:.3f})",
              flush=True)
    print(json.dumps({
        "metric": "multiproc_scaling_efficiency_curve",
        "iters": ITERS, "devices": 4, "rows": rows, "target": 0.8}))


if __name__ == "__main__":
    main()
