#!/usr/bin/env python
"""Run->verify->measure sweep (the run.sh/run_all.sh/extract_result
analog, ``scripts/run_all.sh:22`` NUM_RUNS protocol).

For every parity app: run the reference cpp_omp binary and our CLI
NUM_RUNS times on the committed fixture, verify outputs via
scripts/parity.py once, take median ``running time=``, and rewrite the
measured-baselines table in BASELINE.md between the marker lines.

Usage: python scripts/sweep.py [--runs 3] [--device] [--no-baseline-update]
"""
import argparse
import os
import re
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
REFBIN = os.path.join(REPO, ".refbuild", "apps", "output_cpp", "bin")
FIXTURE = os.path.join(REPO, "data", "parity", "parity10k.bin")
BASELINE = os.path.join(REPO, "BASELINE.md")
MARK_A = "<!-- sweep:begin -->"
MARK_B = "<!-- sweep:end -->"

# (reference binary, our CLI app name)
APPS = [
    ("pagerank", "pagerank"),
    ("hop_dist", "hop_dist"),
    ("triangle_counting", "triangle_counting"),
    ("sssp", "sssp"),
    ("avg_teen_cnt", "avg_teen_cnt"),
    ("conduct", "conduct_main"),
    ("random_node_sampling", "random_node_sampling"),
    ("random_degree_node_sampling", "random_degree_node_sampling"),
]


def ref_time(app, runs):
    ts = []
    for _ in range(runs):
        out = subprocess.run(
            [os.path.join(REFBIN, app), FIXTURE, "2", "."],
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, OMP_NUM_THREADS="2")).stdout
        m = re.findall(r"running time=([0-9.]+)", out)
        ts.append(float(m[0]))
    return statistics.median(ts)


def our_time(app, runs, on_device):
    ts = []
    for _ in range(runs):
        code = (
            "import jax\n"
            + ("" if on_device else
               "jax.config.update('jax_platforms','cpu')\n")
            + "import sys\nsys.path.insert(0, '.')\n"
            + "from green_marl_tpu.cli.apps import main\n"
            + f"main(['{app}', '-GMMeasureTime=1', {FIXTURE!r}])\n")
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=600,
                             cwd=REPO).stdout
        m = re.findall(r"running time=([0-9.]+)", out)
        if not m:
            return None
        ts.append(float(m[0]))
    return statistics.median(ts)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--device", action="store_true")
    ap.add_argument("--no-baseline-update", action="store_true")
    args = ap.parse_args()

    print("== verification (scripts/parity.py) ==")
    rc = subprocess.run([sys.executable,
                         os.path.join(REPO, "scripts", "parity.py")]
                        + (["--device"] if args.device else []),
                        cwd=REPO).returncode
    if rc != 0:
        print("parity FAILED; not recording timings")
        return rc

    rows = []
    for ref_app, our_app in APPS:
        rt = ref_time(ref_app, args.runs)
        ot = our_time(our_app, args.runs, args.device)
        note = "" if ot is not None else " (no timing line)"
        rows.append((ref_app, rt, ot, note))
        print(f"{ref_app:32s} ref {rt:10.3f} ms   "
              f"ours {ot if ot is not None else float('nan'):10.3f} ms"
              f"{note}")

    if args.no_baseline_update:
        return 0

    side = "device" if args.device else "CPU"
    lines = [MARK_A,
             f"### Measured baselines (parity10k fixture, "
             f"NUM_RUNS={args.runs}, reference=2 OpenMP threads, "
             f"ours={side}; medians of `running time=`)",
             "",
             "| app | reference (ms) | ours (ms) |",
             "|---|---|---|"]
    for app, rt, ot, note in rows:
        o = f"{ot:.1f}" if ot is not None else "—"
        lines.append(f"| {app} | {rt:.1f} | {o}{note} |")
    lines.append(MARK_B)
    block = "\n".join(lines)

    text = open(BASELINE).read() if os.path.exists(BASELINE) else ""
    if MARK_A in text and MARK_B in text:
        pre = text.split(MARK_A)[0]
        post = text.split(MARK_B)[1]
        text = pre + block + post
    else:
        text = text.rstrip() + "\n\n" + block + "\n"
    open(BASELINE, "w").write(text)
    print(f"BASELINE.md updated ({len(rows)} apps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
