"""Finds an open-loop cell's knee: the highest arrival rate the program
sustains without a growing backlog. One process, one set-up, then one
window per rate:

    python3 port_bench/sweep.py --workload bf16-interactive --seed 7 --seconds 10 --rates 200,300,400

For each rate it prints the latency median and 95th percentile over all
requests, the completion rate, and the backlog's growth: the median latency
of the last quarter of requests (by due time) over that of the first. The
knee is the highest rate whose growth stays near 1; the cell's rate is set
to about four fifths of it, in its traffic file. No check is run here.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import run as _env  # noqa: E402,F401  (caches and environment, as a run sets them)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)

    import numpy as np

    from port_bench import harness, traffic
    from port_bench.spec import load_cell

    cell = load_cell(args.workload)
    rates = [float(r) for r in args.rates.split(",")]
    cell.traffic = dict(cell.traffic, rate_per_s=max(rates))
    run = harness.Run(cell, args.seed, args.seconds, False, T_START,
                      log=lambda m: print(m, file=sys.stderr, flush=True))
    run.setup()
    print(f"set-up {run.setup_s:.3f} s", flush=True)
    for rate in rates:
        run.mix = dict(cell.traffic, rate_per_s=rate)
        run.reqs = traffic.generate(run.mix, cell.config, args.seed, args.seconds)
        run.n_tok = np.array([len(t) for t in run.reqs.tokens])
        run.flagged = run.probe.flagged = set()
        run.probe.dispatches = []
        run.window()
        for line in run.profile_lines():
            print(line, file=sys.stderr, flush=True)
        n = run.attempted
        lat = np.array([(run.done[i][0] if i in run.done else run.give_up)
                        - (run.t0 + run.reqs.due[i]) for i in range(n)]) * 1e3
        q = max(1, n // 4)
        row = {"rate": rate, "requests": n, "done": len(run.done),
               "p50_ms": traffic.percentile(lat, 50), "p95_ms": traffic.percentile(lat, 95),
               "completed_per_s": len(run.done) / (run.t_end - run.t0),
               "growth": float(np.median(lat[-q:]) / np.median(lat[:q])),
               "rows_per_call": run.batcher_counts["requests"] / max(1, run.batcher_counts["dispatches"])}
        print(json.dumps(row), flush=True)
    run.batcher.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
