"""The readings that a cell's limits are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds S1 S2 ... \\
        [--control-seeds C1 C2 ...]

One process, so set-up is paid once.  For each of ``--seeds``: one run of
the cell with a window of one step (the timed path at the cell's sizes),
printing every number compared.  For each of ``--control-seeds``: the
control, the plain reference with every linear layer in float8 e4m3 put
in the program's place, against the reference in bfloat16 on the same
weights, tokens and rows; the numbers the trace-buffer comparison reads
take no part in it.  One JSON line each, then the largest and smallest
of each reading.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def control_reading(cell, seed: int, device: str) -> float:
    import torch
    from portbench import check, reflib, weights
    cfg, tr = cell.ref_cfg, cell.traffic
    gen = weights.generator(seed, device)
    params = weights.draw(cell.reference.layout(cfg), gen, device)
    x = weights.tokens(cfg, gen, tr["batch"], tr["seq_len"], device)
    rows = check.sample_rows(seed, tr["batch"], tr["seq_len"])
    idx = tuple(torch.as_tensor(r, device=device) for r in rows)
    out = {}
    with torch.inference_mode():
        for prec in ("bf16", "fp8"):
            h = cell.reference.hidden(params, x, cfg, prec)
            out[prec] = reflib.head_rows(params, h, idx, cfg, prec).float().cpu()
            del h
    del params, x
    gc.collect()
    torch.cuda.empty_cache()
    return check.logit_err(out["fp8"], out["bf16"])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA card")
    cell = harness.load_cell(ROOT, args.workload)
    readings: dict = {}
    for seed in args.seeds:
        res = harness.run_cell(cell, seed, 0.0, False, "cuda", time.perf_counter())
        values = {k: c["value"] for k, c in res["checks"].items()}
        print(json.dumps({"program": seed, **values}), flush=True)
        for k, v in values.items():
            readings.setdefault(f"program {k}", []).append(v)
        gc.collect()
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        err = control_reading(cell, seed, "cuda")
        print(json.dumps({"control": seed, "logit_err": err}), flush=True)
        readings.setdefault("control logit_err", []).append(err)
    for k, v in readings.items():
        print(f"{cell.name} {k}: largest {max(v)!r}, smallest {min(v)!r} "
              f"over {len(v)} seeds", flush=True)
    print(f"calibrate: {time.perf_counter() - T0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
