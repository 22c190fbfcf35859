#!/usr/bin/env python
"""Output-parity harness: reference cpp_omp binaries vs this framework.

Reference side: binaries built from the reference compiler into
``.refbuild/`` (see scripts/build_reference.sh; the in-tree reference is
read-only, so it is copied + patched there).  Both sides run on the SAME
committed fixture graph (``data/parity/parity10k.bin``, generated once by
the reference ``graph_gen 10000 80000 ... 2``), mirroring the reference
regression protocol (``test/regression/test.py:82-175``) and the value
goldens of ``scripts/extract_result.py:236-330``.

Checks per app:
  pagerank           rank[0..3] printed values (exact-string match: both
                     sides accumulate in float64; the reference prints
                     %0.9lf)
  hop_dist           dist[0..9] values + CRC-16 of the full int32 dist
                     array (bit-exact — integer BFS levels)
  triangle_counting  the count (exact)

Usage:  python scripts/parity.py [--device]   (default runs our side on CPU)
Prints a PASS/FAIL table and exits nonzero on any mismatch.
"""
import argparse
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFBIN = os.path.join(REPO, ".refbuild", "apps", "output_cpp", "bin")
FIXTURE = os.path.join(REPO, "data", "parity", "parity10k.bin")


def run_ref(app, extra=()):
    exe = os.path.join(REFBIN, app)
    out = subprocess.run([exe, FIXTURE, "8", ".", *extra],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="8"))
    return out.stdout


def run_ours(app, on_device=False, extra=()):
    env = dict(os.environ)
    code = (
        "import jax\n"
        + ("" if on_device else "jax.config.update('jax_platforms','cpu')\n")
        + "import sys\n"
        + f"sys.argv = ['run', '{app}', {FIXTURE!r}] + {list(extra)!r}\n"
        + "from green_marl_tpu.cli.run import main\nmain()\n")
    out = subprocess.run([sys.executable, "-c", code],
                         capture_output=True, text=True, timeout=600,
                         cwd=REPO, env=env)
    if out.returncode != 0:
        raise RuntimeError(f"{app} failed:\n{out.stderr[-2000:]}")
    return out.stdout


def grab(pattern, text):
    return re.findall(pattern, text, re.M)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", action="store_true",
                    help="run our side on JAX's default accelerator "
                         "instead of the CPU")
    args = ap.parse_args()

    if not os.path.exists(os.path.join(REFBIN, "pagerank")):
        print("reference binaries not built; run scripts/build_reference.sh")
        return 2

    failures = []

    def check(name, ok, detail=""):
        print(f"{'PASS' if ok else 'FAIL'}  {name}  {detail}")
        if not ok:
            failures.append(name)

    # ---- pagerank -------------------------------------------------------
    ref = run_ref("pagerank")
    ours = run_ours("pagerank", args.device)
    r_ranks = grab(r"^rank\[\d\] = ([0-9.eE+-]+)", ref)[:4]
    o_ranks = grab(r"^rank\[\d\] = ([0-9.eE+-]+)", ours)[:4]
    if args.device:
        ok = all(abs(float(a) - float(b)) <= 1e-9 + 1e-4 * abs(float(a))
                 for a, b in zip(r_ranks, o_ranks))
        check("pagerank rank[0..3] (tol 1e-4 rel, f32 device sums)",
              ok and len(o_ranks) == 4, f"{r_ranks} vs {o_ranks}")
    else:
        check("pagerank rank[0..3] exact print", r_ranks == o_ranks,
              f"{r_ranks} vs {o_ranks}")
    r_time = grab(r"running time=([0-9.]+)", ref)
    print(f"  reference running time: {r_time[0]} ms")

    # ---- hop_dist -------------------------------------------------------
    ref = run_ref("hop_dist")
    ours = run_ours("hop_dist", args.device)
    r_d = grab(r"^dist\[\d\] = (-?\d+)", ref)[:10]
    o_d = grab(r"^dist\[\d\] = (-?\d+)", ours)[:10]
    check("hop_dist dist[0..9]", r_d == o_d and len(o_d) == 10,
          f"{r_d} vs {o_d}")
    r_crc = grab(r"^CRC shl__G_dist (0x[0-9a-f]+)", ref)
    o_crc = grab(r"^CRC16 dist (0x[0-9a-f]+)", ours)
    if r_crc and o_crc:
        check("hop_dist dist[] CRC16 bit-exact", r_crc[0] == o_crc[0],
              f"{r_crc[0]} vs {o_crc[0]}")
    else:
        check("hop_dist CRC lines present", bool(r_crc) and bool(o_crc),
              f"ref={r_crc} ours={o_crc}")
    r_time = grab(r"running time=([0-9.]+)", ref)
    print(f"  reference running time: {r_time[0]} ms")

    # ---- triangle_counting ---------------------------------------------
    ref = run_ref("triangle_counting")
    ours = run_ours("triangle_counting", args.device)
    r_t = grab(r"number of triangles: (\d+)", ref)
    o_t = grab(r"number of triangles: (\d+)", ours)
    check("triangle count exact", r_t == o_t, f"{r_t} vs {o_t}")
    r_time = grab(r"running time=([0-9.]+)", ref)
    print(f"  reference running time: {r_time[0]} ms")

    # ---- sssp (xorshift weights replicated bit-exact) -------------------
    ref = run_ref("sssp")
    ours = run_ours("sssp", args.device)
    r_d = grab(r"^dist\[\d\] = (-?\d+)", ref)[:10]
    o_d = grab(r"^dist\[\d\] = (-?\d+)", ours)[:10]
    check("sssp dist[0..9] (replicated gm_rand32 weights)",
          r_d == o_d and len(o_d) == 10, f"{r_d} vs {o_d}")
    r_time = grab(r"running time=([0-9.]+)", ref)
    print(f"  reference running time: {r_time[0]} ms")

    # ---- avg_teen_cnt ---------------------------------------------------
    ref = run_ref("avg_teen_cnt")
    ours = run_ours("avg_teen_cnt", args.device)
    r_a = grab(r"^avg = ([0-9.]+)", ref)
    o_a = grab(r"^avg = ([0-9.]+)", ours)
    check("avg_teen_cnt avg exact print", r_a == o_a,
          f"{r_a} vs {o_a}")
    r_time = grab(r"running time=([0-9.]+)", ref)
    print(f"  reference running time: {r_time[0]} ms")

    # ---- conduct (xorshift membership replicated) -----------------------
    ref = run_ref("conduct")
    ours = run_ours("conduct_main", args.device)
    r_c = grab(r"^sum C = ([0-9.]+)", ref)
    o_c = grab(r"^sum C = ([0-9.]+)", ours)
    ok = (bool(r_c) and bool(o_c)
          and abs(float(r_c[0]) - float(o_c[0])) < 5e-6)
    check("conduct sum C (4 xorshift cuts, tol 5e-6)", ok,
          f"{r_c} vs {o_c}")
    r_time = grab(r"running time=([0-9.]+)", ref)
    print(f"  reference running time: {r_time[0]} ms")

    # ---- sampling family (outputs are random; protocol + rc parity) ----
    for app in ("random_node_sampling", "random_degree_node_sampling"):
        ref = run_ref(app)
        ours = run_ours(app, args.device)
        ok = ("GM DONE" in ref
              and bool(grab(r"running time=", ref))
              and bool(grab(r"graph loading time=", ours)))
        check(f"{app} protocol/rc", ok)
        r_time = grab(r"running time=([0-9.]+)", ref)
        print(f"  reference running time: {r_time[0]} ms")

    print()
    if failures:
        print(f"{len(failures)} FAILURES: {failures}")
        return 1
    print("ALL PARITY CHECKS PASSED (8 apps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
