"""Check and time variants of the simt (float32 FMA) body of
``instrumented_matmul`` on one card, in turns:

    python3 ab_simt_body.py [VARIANT ...]

A variant is ``base`` (``csrc/instrumented_matmul.cu`` as it is) or a
comma-separated list of ``NAME=VALUE`` that replaces the value of each
named ``constexpr int`` of that source (``SIMT_STAGES=4``,
``SIMT_STAGES=2,SUM_THREADS=256``).  Every variant is built with ``nvcc
-Xptxas -v`` into ``build/simt_variants/`` (the registers, spills and
barriers of its simt and sum kernels printed), then, on glm4-9b's four
layer-0 product shapes at M = 128 with seeded random float32 operands,
held to ``chip_smoke.simt_check`` (trace, float32 bound, two calls
bitwise equal) and timed with a cold L2 as ``chip_smoke.py``'s phase 4
times them, the sum pass apart.  The variants run in the order given and
then in reverse (give ``A B`` for A B B A); float32 ``torch.matmul`` is
timed in each pass beside them.  One JSON line ``AB {...}`` per variant
and pass; a product whose profiler window lost records three times is
null there, and the pass's sums then too.
"""

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as c
from repro_torch.kernels import build
from repro_torch.kernels import instrumented_matmul as im

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "simt_variants"
#: glm4-9b layer-0 products (name, K, N) against a 2 x 64-token activation
PRODUCTS = [("wq", 4096, 4096), ("w_gate", 4096, 13696),
            ("w_down", 13696, 4096), ("lm_head", 4096, 151552)]
M = 128


def _source(variant: str) -> str:
    text = (build.CSRC / "instrumented_matmul.cu").read_text()
    if variant == "base":
        return text
    for item in variant.split(","):
        name, value = item.split("=")
        text, hits = re.subn(rf"(constexpr int {name} = )[^;]+;",
                             rf"\g<1>{value};", text)
        if hits != 1:
            raise SystemExit(f"variant {variant}: {name} is not one "
                             "constexpr int of the source")
    return text


def _ptxas(log: str) -> list:
    """The ptxas lines of the simt and sum kernels."""
    keep, on = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            on = "simt" in line or "matmul_traced_sum" in line
            name = line.split("'")[1] if "'" in line else line
        elif on and ("spill" in line or "Used" in line):
            keep.append(f"{name}: {line.strip()}")
    return keep


def build_variants(variants: list) -> dict:
    """{variant: (loaded library, ptxas lines)}, all compiled in parallel."""
    procs = {}
    for i, v in enumerate(variants):
        d = OUT / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        src = d / "instrumented_matmul.cu"
        src.write_text(_source(v))
        lib = d / "instrumented_matmul.so"
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
               str(build.CSRC), "-o", str(lib), str(src)]
        procs[v] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    lib)
    built = {}
    for v, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {v}: nvcc exited {proc.returncode}\n"
                             f"{log}")
        dll = ctypes.CDLL(str(lib))
        fn = dll.instrumented_matmul_launch
        fn.argtypes = build.SIGNATURES["instrumented_matmul"]
        fn.restype = ctypes.c_int
        dll.pasta_error_string.argtypes = [ctypes.c_int]
        dll.pasta_error_string.restype = ctypes.c_char_p
        built[v] = (dll, _ptxas(log))
    return built


def main(variants: list) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    built = build_variants(variants)
    g = torch.Generator(device="cuda").manual_seed(c.SEED)
    operands = {name: (torch.randn((M, k), generator=g, device="cuda"),
                       torch.randn((k, n), generator=g, device="cuda"))
                for name, k, n in PRODUCTS}
    flush_buf = torch.empty(c.FLUSH_BYTES // 4, dtype=torch.int32,
                            device="cuda")

    def flush():
        flush_buf.bitwise_not_()

    for v in variants:
        print(f"variant {v} ptxas: {built[v][1]}", flush=True)
    checked = set()
    for v in variants + variants[::-1]:
        build._libs["instrumented_matmul"] = built[v][0]
        info = im._simt_info(torch.device("cuda"), torch.float32, "async")
        row = {"variant": v, "card": c.CARD, "info": info, "products": {}}
        for name, (x, w) in operands.items():
            k, n = x.shape[1], w.shape[1]
            if v not in checked:
                c.simt_check(f"{v} {name}", x, w)
            parts = c.cold_parts_ms(lambda: im.matmul_traced(x, w), flush)
            lib = c.cold_ms(lambda: torch.matmul(x, w), flush)
            if parts is None or lib is None:
                # a known loss of torch.profiler late in a process: this
                # product goes untimed in this pass, the others stand
                row["products"][name] = None
                continue
            ms = sum(parts.values())
            bound = 2 * M * n * k / c.FP32_FLOPS * 1e3
            row["products"][name] = {
                "ms": ms, "sum_ms": sum(t for kn, t in parts.items()
                                        if "matmul_traced_sum" in kn),
                "library_f32_ms": lib, "bound_ms": bound,
                "split": im._simt_plan(M, k, n, c.ops._sms(x.device),
                                       x.dtype)[0]}
        checked.add(v)
        timed = [p for p in row["products"].values() if p is not None]
        whole = len(timed) == len(PRODUCTS)
        row["sum_ms"] = sum(p["ms"] for p in timed) if whole else None
        row["library_f32_sum_ms"] = (sum(p["library_f32_ms"] for p in timed)
                                     if whole else None)
        print("AB " + json.dumps(row), flush=True)


if __name__ == "__main__":
    c.CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(f"card: {c.CARD}", flush=True)
    main(sys.argv[1:] or ["base"])
