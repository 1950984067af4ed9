"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is the result object; the last
lines of standard error are the numbers compared, each with its limit.
It exits non-zero and prints no result when there is no CUDA card or
too few, when the port (``src/repro_torch``) is not beside it, and when
JAX or the JAX package is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names that may not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def fail(msg: str, code: int = 2) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"the port is not in {ROOT / 'src' / 'repro_torch'}")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    t_torch = time.perf_counter() - T0
    from portbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    harness.log(f"imports: torch {t_torch:.3f} s, the harness "
                f"{time.perf_counter() - T0 - t_torch:.3f} s")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this benchmark needs CUDA cards")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{cell.name} needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} are visible")
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              "cuda", T0)
    loaded = sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
    if loaded:
        fail(f"modules that may not be loaded are: {', '.join(loaded)}", 3)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
