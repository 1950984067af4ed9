"""Peak device memory of a full-width stablelm-1.6b train step (one card,
float32 weights and moments, batch 2 x 64) at one microbatch and at two,
for each source tree named on the command line, in turn:

    python3 ab_microbatch_peak.py OLD_TREE NEW_TREE NEW_TREE OLD_TREE

Each tree is a checkout of this repository (its ``src`` holds the
``repro_torch`` that runs); each run is a fresh process that traces both
steps for their static peak estimate (fake CUDA tensors), runs each once
and prints one line ``AB {"tree", "m1", "m2"}``, each step with its
``estimate`` and ``measured`` (``torch.cuda.max_memory_allocated``)
bytes.  Compare two trees only within one invocation.
"""

import json
import os
import subprocess
import sys


def _one(tree: str) -> None:
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch
    import repro_torch.configs as configs
    from repro_torch import analysis
    from repro_torch.core.trace import trace_step
    from repro_torch.models import init_params
    from repro_torch.train import OptConfig, init_opt_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get("stablelm-1.6b")
    opt_cfg = OptConfig()
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                              dtype=torch.int32, device="cuda")
             for k in ("inputs", "labels")}
    out = {"tree": tree}
    for m in (1, 2):
        params = init_params(cfg, 0, "cuda")
        state = init_opt_state(params, opt_cfg)
        step = make_train_step(cfg, opt_cfg, microbatches=m)
        est = analysis.estimate_peak_bytes(
            trace_step(step, params, state, batch, device_type="cuda"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = step(params, state, batch)
        torch.cuda.synchronize()
        out[f"m{m}"] = {"estimate": est["peak_bytes"],
                        "measured": torch.cuda.max_memory_allocated(),
                        "loss": float(res[2]["loss"])}
        del res, params, state
        torch.cuda.empty_cache()
    print("AB " + json.dumps(out), flush=True)


def main() -> None:
    if sys.argv[1:2] == ["--one"]:
        _one(os.path.abspath(sys.argv[2]))
        return
    for tree in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        tree], check=True, timeout=900)


if __name__ == "__main__":
    main()
