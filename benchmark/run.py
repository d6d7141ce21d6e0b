"""Runs one cell of the benchmark once, on the CUDA card(s) of this
machine, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It sets the program up (imports, the scene's lowering, the renderer,
the kernels, the mix's warm-up requests), measures for `--seconds`
seconds, checks the sampled outputs against the plain reference, and
prints one JSON object as the last line of standard output. Set-up's
parts, and each number the check compared beside its limit, go to
standard error. It exits with 3 and prints no result where the cell's
cards are missing, and with 1 where the program or the benchmark fails.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: CUDA's kernel cache, at a fixed place in the checkout (the program's
#: own builds go to `fidget_tpu_torch/_build/`, also in the checkout)
CACHE = ROOT / "benchmark" / ".cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    args = ap.parse_args(argv)
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    sys.path.insert(0, str(ROOT))
    from benchmark.core import cell

    try:
        result = cell.run(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except cell.NoChip as e:
        print(f"[bench] {e}", file=sys.stderr)
        return 3
    for name, chk in result["checks"].items():
        print(f"[bench] check {name} = {chk['value']!r} (limit "
              f"{chk['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
