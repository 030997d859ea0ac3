"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout.  The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each number
compared with its limit); the same numbers are the last lines of standard
error.  Exits 2 without a result when the machine has fewer CUDA devices
than the cell asks for, and 1 on any other failure.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), ".portbench_cache")


def cache_bytecode() -> None:
    """Keep Python's compiled modules (torch's 900 among them) under the
    checkout's cache, so that only a checkout's first run compiles them,
    also where the environment sets PYTHONDONTWRITEBYTECODE."""
    sys.pycache_prefix = os.path.join(CACHE, "pycache")
    sys.dont_write_bytecode = False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cache_bytecode()
    from portbench import harness
    try:
        bench = harness.benchmark()
        cell = next(c for c in bench["workloads"] if c["name"] == a.workload)
        result, frames = harness.run(a.workload, a.seed, a.seconds,
                                     bool(a.trace), chips=int(cell["chips"]))
    except harness.Unavailable as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    except StopIteration:
        print(f"portbench: no workload {a.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 1
    except Exception:                       # report, print no result
        traceback.print_exc()
        return 1
    for i, p in frames.items():
        print(f"portbench: frame {i}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in p.items()), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
